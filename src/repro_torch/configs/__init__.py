from .registry import ARCH_IDS, get_config, get_tiny  # noqa: F401
from .shapes import SHAPES, cell_applicable, input_specs  # noqa: F401
