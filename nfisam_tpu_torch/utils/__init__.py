from .device import resolve_device
from .keys import KeyStream, split_host, torch_generator
