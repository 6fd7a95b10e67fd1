"""The benchmark of multimodalmusig_tpu_torch, the PyTorch and CUDA port:
best-of-N MMCTM fits timed per selected model on one CUDA card, checked
against a plain reference. `python3 -m portbench.run --help`."""
