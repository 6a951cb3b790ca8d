"""Runners of the JAX package's ``scripts/``, each under the script's own
name (``python -m nfisam_tpu_torch.scripts.<name>``)."""
