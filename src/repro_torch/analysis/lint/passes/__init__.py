"""Built-in lint passes — importing this module registers them.

The port's counterparts of :mod:`repro.analysis.lint.passes`, under the
same rule ids; the catalogue lives in ``docs/static_analysis_torch.md``.
Adding a pass: subclass :class:`repro_torch.analysis.lint.core.LintPass`,
decorate with :func:`repro_torch.analysis.lint.core.register`, import it
here.
"""
from . import (dtype_discipline, event_taxonomy, exception_hygiene,  # noqa: F401
               jit_purity, schema_roundtrip)

__all__ = ["jit_purity", "dtype_discipline", "event_taxonomy",
           "schema_roundtrip", "exception_hygiene"]
