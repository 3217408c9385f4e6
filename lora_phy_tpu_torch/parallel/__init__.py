"""The time/channel-sharded receivers: device meshes, the per-shard
bodies and the multi-process layer."""
