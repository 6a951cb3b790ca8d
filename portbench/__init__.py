"""The benchmark of the PyTorch and CUDA port (``nfisam_tpu_torch``): a
harness driven by the data files beside it (``README.md``)."""
