"""Golden-vector manifest tooling: base64 encoding + SHA256 manifests —
the port's own copy of ``lora_phy_tpu/utils/manifest.py`` (pure Python).

Reproduces the reference's vector-directory contract
(reference: runners/lora_phy_vector_generate.cpp:65-86, 241-272 — files are
base64-encoded with a ``.b64`` suffix and hashed into ``manifest.json``)
without shelling out to ``sha256sum``/``mkdir`` the way the reference does.
Also provides the regression comparator (reference: scripts/compare_vectors.py:17-61).
"""

from __future__ import annotations

import base64
import hashlib
import json
import pathlib


def sha256_file(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def b64_encode_file(path) -> pathlib.Path:
    """Replace ``path`` with ``path.b64`` holding its base64 encoding,
    mirroring the reference's post-processing (lora_phy_vector_generate.cpp:65-86)."""
    path = pathlib.Path(path)
    data = path.read_bytes()
    out = path.with_name(path.name + ".b64")
    out.write_bytes(base64.b64encode(data))
    path.unlink()
    return out


def write_manifest(directory, files=None) -> pathlib.Path:
    """Hash every file in ``directory`` into ``manifest.json``
    (schema: {"files": {name: sha256}})."""
    directory = pathlib.Path(directory)
    names = sorted(
        f.name for f in directory.iterdir()
        if f.is_file() and f.name != "manifest.json"
    ) if files is None else list(files)
    manifest = {"files": {n: sha256_file(directory / n) for n in names}}
    out = directory / "manifest.json"
    out.write_text(json.dumps(manifest, indent=2, sort_keys=True) + "\n")
    return out


def compare_dirs(dir_a, dir_b) -> list[str]:
    """Return a list of mismatch descriptions between two vector dirs
    (empty = identical), per the reference's compare_vectors.py semantics:
    every non-manifest file must exist in both and hash identically."""
    dir_a, dir_b = pathlib.Path(dir_a), pathlib.Path(dir_b)
    errors = []
    names_a = {f.name for f in dir_a.iterdir() if f.is_file() and f.name != "manifest.json"}
    names_b = {f.name for f in dir_b.iterdir() if f.is_file() and f.name != "manifest.json"}
    for missing in sorted(names_a - names_b):
        errors.append(f"missing in {dir_b}: {missing}")
    for missing in sorted(names_b - names_a):
        errors.append(f"missing in {dir_a}: {missing}")
    for name in sorted(names_a & names_b):
        ha, hb = sha256_file(dir_a / name), sha256_file(dir_b / name)
        if ha != hb:
            errors.append(f"hash mismatch: {name} ({ha[:12]} != {hb[:12]})")
    return errors
