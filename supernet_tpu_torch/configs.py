"""The JAX package's configs, re-exported: ``supernet_tpu.configs`` imports
no JAX, so both packages read one definition."""

from supernet_tpu.configs import *  # noqa: F401,F403
from supernet_tpu.configs import __all__  # noqa: F401
