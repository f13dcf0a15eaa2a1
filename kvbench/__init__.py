"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): YCSB
cells over the ordered key-value store's served path.  See README.md."""
