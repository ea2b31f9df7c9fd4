from .adamw import AdamWState, adamw_init, adamw_update  # noqa: F401
from .schedule import cosine_schedule, linear_warmup  # noqa: F401
