from .metrics import mmd
