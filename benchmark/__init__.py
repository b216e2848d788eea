"""The benchmark of thinshelllab_torch on an NVIDIA H100 (see README.md)."""
