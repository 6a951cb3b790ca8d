"""nfisam_tpu_torch: the NF-iSAM solver of ``nfisam_tpu`` in PyTorch and
CUDA, for NVIDIA Hopper GPUs.

Incremental smoothing and mapping via normalizing flows on the Bayes
tree: the JAX package's layout, in PyTorch idiom (plain functions on
tensors, parameters as dicts of tensors, explicit devices and
``torch.Generator``s), with the masked autoregressive flow inverse as a
hand-written CUDA kernel (``csrc/ar_inverse.cu``).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.  The package imports
neither JAX nor ``nfisam_tpu``.
"""
__version__ = "0.1.0"
