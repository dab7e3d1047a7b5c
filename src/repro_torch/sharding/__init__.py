from .rules import (  # noqa: F401
    spec_for, params_specs, params_shardings, batch_spec, layout_for,
    validate_specs, placements,
)
