"""Static-analysis subsystem of the port: dispatch-level contract
checks (`tracecheck`), repo AST lint (`lint`), and the `CompileGuard`
signature budget every guarded entry point routes through.

Only `CompileGuard` is exported eagerly — `core/` and `serve/` import
it, so this package must not import them back at import time.  The
checkers live behind `repro_torch.analysis.cli`.
"""
from .compileguard import CompileGuard, CompileGuardError

__all__ = ["CompileGuard", "CompileGuardError"]
