from .device import resolve_device
from .keys import KeyStream, generator_seed, split_host, torch_generator
