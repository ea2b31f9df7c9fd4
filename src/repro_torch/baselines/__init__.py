"""The paper's baselines (port of ``repro/baselines``): RTN, GPTQ and AWQ
per weight (``quant_baselines``) and over a model (``apply``)."""
from .quant_baselines import awq_quantize, gptq_quantize, rtn_quantize  # noqa: F401
