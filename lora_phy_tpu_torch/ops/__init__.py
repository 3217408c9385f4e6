"""Numeric primitives of the port (coding, chirp, DFT, planar demod, fused kernel)."""
