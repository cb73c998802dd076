"""Static analysis of Study plans, before anything runs.

Mirrors the plan half of ``src/repro/analysis/``:

* :mod:`repro_torch.analysis.plan_check` — the pre-execution report on a
  ``Plan``: the distinct launch shapes its schedule can produce
  (``recompile-storm`` past ``STORM_THRESHOLD``), the source cache's
  budget feasibility, checkpoint step-key ranges, dead lanes.
  ``run_plan`` runs it in advisory mode by default; the study daemon's
  admission is the strict consumer, which also replays the schedule
  through the simulator (time-resolved budget findings).
* :mod:`repro_torch.analysis.plan_sim` — the static schedule simulator: the
  ``LanePool`` loop replayed over a plan without kernels or solves,
  emitting the live pool's trace events.
* :mod:`repro_torch.analysis.findings` — the shared ``Finding`` /
  ``Report`` structure.

The reference's ``jit_lint``, ``kernel_lint`` and ``imports`` lint JAX and
Pallas source and have no counterpart here yet.
"""
from repro_torch.analysis.findings import Finding, Report  # noqa: F401
