from .masked import (  # noqa: F401
    AdamState, SGDState, adam_init, adam_step, sgd_init, sgd_step,
)
