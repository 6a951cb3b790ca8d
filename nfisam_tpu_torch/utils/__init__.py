from .device import resolve_device
from .keys import (KeyStream, generator_seed, host_key, split_host,
                   torch_generator)
