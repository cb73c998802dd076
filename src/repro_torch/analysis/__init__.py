"""Static analysis: Study plans before anything runs, and lint passes over
the port's source. Mirrors ``src/repro/analysis/``:

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
* :mod:`repro_torch.analysis.jit_lint` — AST lint of the port's eager
  CUDA code: ``timer-no-sync``, and in the bodies that must not sync the
  host (``SYNC_FREE``) ``host-sync-cast``, ``host-sync-branch`` and
  ``data-dependent-shape``.
* :mod:`repro_torch.analysis.kernel_lint` — static checks on the
  hand-written launches: ``device-contract`` (the wrappers),
  ``grid-tail``, ``smem-footprint`` and ``acc-dtype`` (``kernels/csrc``,
  and TF32 in every module).
* :mod:`repro_torch.analysis.findings` — the shared ``Finding`` /
  ``Report`` structure, and the committed baseline
  (``results/lint_baseline_torch.json``) that lets the gate fail on NEW
  findings only.
* :mod:`repro_torch.analysis.imports` — the intra-package import graph the
  lint scope comes from (the LM zoo, which nothing on the SVM paths
  imports, is left out).

``python -m repro_torch.analysis --check`` runs the lint passes and a plan
smoke against the baseline (``__main__``, the counterpart of
``scripts/repro_lint.py``).
"""
from repro_torch.analysis.findings import Finding, Report  # noqa: F401
