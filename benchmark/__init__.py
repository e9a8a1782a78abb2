"""The benchmark of msclip_torch: ``python3 -m benchmark.run``."""
