"""Static analysis: certify plans and schedules before anything executes.

The port's copy of ``repro/analysis/`` without its JAX source linter.  Two
passes over the artifacts the search exchanges with the runtime,
sharing one structured-diagnostic model (rule ids catalogued in
``docs/analysis.md``):

  * :mod:`repro_torch.analysis.schedule_lint` — happens-before certification of
    compiled ``ScheduleProgram`` tick tables (SCH rules): deadlock /
    use-before-def / double-consume detection, certified peak live-buffer
    counts pinned against the cost model, bubble re-derivation.
  * :mod:`repro_torch.analysis.plan_lint` — static checks on ``ParallelPlan``
    JSON, all format versions (PLN rules).

The search CLI runs the plan + schedule passes on every plan before
serializing it; ``compile_schedule(..., validate=True)`` routes through the
schedule pass.
"""
from .diagnostics import (ERROR, INFO, WARNING, Diagnostic, DiagnosticError,
                          DiagnosticReport, error, info, warning)
from .plan_lint import (certify_plan_json, detect_format_version,
                        load_plan_file, load_plan_json, verify_plan,
                        verify_plan_json)
from .schedule_lint import (DEFAULT_GRID, StageCertificate, certify_live_buffers,
                            certify_program, schedule_grid, schedule_legal,
                            verify_program)

__all__ = [
    "Diagnostic", "DiagnosticReport", "DiagnosticError",
    "ERROR", "WARNING", "INFO", "error", "warning", "info",
    "verify_program", "certify_program", "certify_live_buffers",
    "StageCertificate", "schedule_legal", "schedule_grid", "DEFAULT_GRID",
    "verify_plan", "verify_plan_json", "certify_plan_json",
    "load_plan_json", "load_plan_file", "detect_format_version",
]
