"""The port's lint passes (``repro_torch.analysis``: ``imports``,
``jit_lint``, ``kernel_lint`` and ``python -m repro_torch.analysis``), as
``tests/test_analysis.py`` holds the reference's: each rule fires on its bad
twin and not on its clean twin (fixtures written from strings into
``tmp_path``), the port's scope is clean against
``results/lint_baseline_torch.json``, the scope derivation holds the port's
split, and the CLI gates on new findings."""
import json
import pathlib
import textwrap

import pytest

from repro_torch.analysis import findings, imports, jit_lint, kernel_lint
from repro_torch.analysis.__main__ import main, plan_smoke, run

REPO = pathlib.Path(__file__).resolve().parents[1]
BASELINE = REPO / "results" / "lint_baseline_torch.json"


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(textwrap.dedent(text))
    return p


def _rules(report):
    return {f.rule for f in report}


def _symbols(report, rule):
    return sorted({f.symbol for f in report if f.rule == rule})


# ------------------------------------------------------------- jit_lint

TIMER = """
    import time
    import torch


    def _sync(dev):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


    def timed_bad(K):
        t0 = time.perf_counter()
        out = K @ K
        return out, time.perf_counter() - t0


    def timed_ok(K):
        t0 = time.perf_counter()
        out = K @ K
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0


    def timed_by_helper(K):
        t0 = time.perf_counter()
        out = K @ K
        _sync(K.device)
        return out, time.perf_counter() - t0


    def timed_by_read(K):
        t0 = time.perf_counter()
        n = int((K > 0).sum())
        return n, time.perf_counter() - t0


    class Pool:
        def _step(self, K):
            return float(K.max())

        def timed_by_method(self, K):
            t0 = time.perf_counter()
            self._step(K)
            return time.perf_counter() - t0
"""


def test_timer_no_sync_fires_on_an_unsynced_span(tmp_path):
    """A span with no sync is flagged; a span synced lexically, through a
    module helper (``core/cv.py``'s ``_sync``), by a host read or through a
    ``self.`` method is not."""
    rpt = jit_lint.lint_paths([_write(tmp_path, "timers.py", TIMER)])
    assert _rules(rpt) == {"timer-no-sync"}
    assert _symbols(rpt, "timer-no-sync") == ["timed_bad"]


def test_timer_sync_propagates_through_imports(tmp_path):
    """``from repro_torch.x import name`` of a syncing function satisfies
    the span (function-level imports included)."""
    pkg = tmp_path / "repro_torch" / "core"
    pkg.mkdir(parents=True)
    helper = _write(pkg, "helpers.py", """
        import torch


        def block(t):
            torch.cuda.synchronize(t.device)
    """)
    user = _write(tmp_path, "user.py", """
        import time


        def timed(K):
            from repro_torch.core.helpers import block
            t0 = time.perf_counter()
            block(K @ K)
            return time.perf_counter() - t0


        def timed_alone(K):
            t0 = time.perf_counter()
            K @ K
            return time.perf_counter() - t0
    """)
    rpt = jit_lint.lint_paths([helper, user])
    assert _symbols(rpt, "timer-no-sync") == ["timed_alone"]


SYNC_FREE_SRC = """
    import torch


    def cast_bad(K, y, C):
        n = int((y > 0).sum())
        top = K.max().item()
        rows = y.tolist()
        u, s, vt = torch.linalg.svd(K)
        return n, top, rows, s


    def cast_ok(K, y, C):
        n = int(y.shape[0])
        c = float(C)
        sol = torch.linalg.solve_ex(K, y, check_errors=False).result
        return torch.where(y > 0, c, 0.0)[:n] + sol


    def branch_bad(K, y, C):
        if (y > 0).any():
            y = -y
        while K.sum() > 0:
            K = K - 1
        return K, y


    def branch_ok(K, y, C, alpha=None):
        if alpha is None:
            alpha = torch.zeros_like(y)
        if C > 1.0 and K.shape[0] > 2 and K.is_cuda:
            alpha = alpha + 1
        return alpha


    def shape_bad(K, y, train_mask):
        idx = torch.nonzero(y > 0)
        picked = K[train_mask]
        free = (y > 0) & (y < 1)
        f = y[free]
        rows = torch.where(train_mask)
        sel = y.masked_select(train_mask)
        vals = torch.unique(y)
        y[~free] = 0.0
        return idx, picked, f, rows, sel, vals


    def shape_ok(K, y, train_mask, idx):
        free = (y > 0) & (y < 1)
        f = torch.where(free, y, 0.0)
        rows = K.index_select(0, idx)
        return f, rows, y[idx], K[:, 0]


    class Ledger:
        def step(self, active_c, m_new):
            self.m = int(m_new)
            if self.m > 4:
                return self.cmask & active_c
            return active_c
"""
SYNC_FREE = {("sync_free.py", name): static for name, static in (
    ("cast_bad", ("C",)), ("cast_ok", ("C",)), ("branch_bad", ("C",)),
    ("branch_ok", ("C",)), ("shape_bad", ()), ("shape_ok", ()),
    ("Ledger.step", ("m_new",)))}


def _sync_free_report(tmp_path):
    return jit_lint.lint_paths([_write(tmp_path, "sync_free.py",
                                       SYNC_FREE_SRC)], sync_free=SYNC_FREE)


def test_host_sync_cast_fires_in_a_sync_free_body(tmp_path):
    """``int`` / ``.item()`` / ``.tolist()`` of a tensor and a checked
    ``torch.linalg`` call are flagged; a shape's ``int``, a host C's
    ``float`` and ``solve_ex`` are not."""
    rpt = _sync_free_report(tmp_path)
    assert _symbols(rpt, "host-sync-cast") == ["cast_bad"]
    assert len([f for f in rpt if f.rule == "host-sync-cast"]) == 4


def test_host_sync_branch_fires_on_a_tensors_value(tmp_path):
    """``if`` / ``while`` on a tensor's value is flagged; ``is None``, a
    host value's test, a shape's and ``is_cuda`` are not; a ledger's
    fields (``self``) are host values."""
    rpt = _sync_free_report(tmp_path)
    assert _symbols(rpt, "host-sync-branch") == ["branch_bad"]
    assert len([f for f in rpt if f.rule == "host-sync-branch"]) == 2


def test_data_dependent_shape_fires_on_data_sized_outputs(tmp_path):
    """``torch.nonzero``, a boolean mask index (a parameter named a mask,
    a comparison's result and its ``~``, loaded or stored), one-argument
    ``torch.where``, ``masked_select`` and ``unique`` are flagged;
    three-argument ``where`` and integer indices are not."""
    rpt = _sync_free_report(tmp_path)
    assert _symbols(rpt, "data-dependent-shape") == ["shape_bad"]
    assert len([f for f in rpt if f.rule == "data-dependent-shape"]) == 7


def test_bodies_outside_the_sync_free_list_are_not_held(tmp_path):
    rpt = jit_lint.lint_paths([_write(tmp_path, "sync_free.py",
                                      SYNC_FREE_SRC)], sync_free={})
    assert len(rpt) == 0


def test_sync_free_list_names_the_ports_functions():
    """Every body ``SYNC_FREE`` names exists in the port (a rename would
    silently drop it from the rules), and each host-value parameter it
    lists is one of the function's."""
    for (suffix, qual), static in jit_lint.SYNC_FREE.items():
        path = REPO / "src" / suffix
        mod = jit_lint._Module(path, str(path))
        assert qual in mod.functions, (suffix, qual)
        params = jit_lint._function_params(mod.functions[qual])
        assert set(static) <= set(params), (suffix, qual, static)


def test_timer_sections_cover_the_ports_timers():
    """The lint sees all ten ``perf_counter`` spans of the port (``core/
    cv.py``, ``core/study.py``, ``svm/scheduler.py``, ``svm/sources.py``,
    ``kernels/_build.py``), and only ``_build``'s (a host build) has no
    sync."""
    found = []
    for p in imports.default_scope():
        mod = jit_lint._Module(p, str(p))
        for qual, fn in mod.functions.items():
            found += [(p.name, qual) for _ in jit_lint._timer_sections(
                fn.body)]
    assert len(found) == 10
    assert {name for name, _ in found} == {"cv.py", "study.py",
                                           "scheduler.py", "sources.py",
                                           "_build.py"}
    rpt = jit_lint.lint_paths(imports.default_scope(), repo_root=REPO)
    assert _symbols(rpt, "timer-no-sync") == ["build_all"]


# ----------------------------------------------------------- kernel_lint

WRAPPERS = """
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import axpy_ref


    def axpy_ok(x, y, a):
        if all(t.device.type == "cpu" for t in (x, y)):
            return axpy_ref(x, y, a)
        if x.device.type != "cuda" or y.device != x.device:
            raise ValueError("axpy: x and y on one CUDA device")
        fn = _build.entry("axpy", "axpy_f64")
        _build.check(fn(x.data_ptr(), y.data_ptr(), a,
                        _build.stream_ptr(x)), "axpy")
        return y


    def _launch(x, y, a):
        fn = _build.entry("axpy", "axpy_f64")
        _build.check(fn(x.data_ptr(), y.data_ptr(), a,
                        _build.stream_ptr(x)), "axpy")
        return y


    def axpy_delegating(x, y, a):
        if x.device.type == "cpu":
            return axpy_ref(x, y, a)
        return axpy_ok(x, y, a)


    def axpy_fallback(x, y, a):
        if x.device.type == "cpu":
            return axpy_ref(x, y, a)
        if not x.is_cuda:
            raise ValueError("axpy: unsupported device")
        try:
            return _launch(x, y, a)
        except RuntimeError:
            return axpy_ref(x.cpu(), y.cpu(), a)


    def axpy_plain_on_card(x, y, a):
        if x.device.type == "cpu":
            return axpy_ref(x, y, a)
        if not x.is_cuda:
            raise ValueError("axpy: unsupported device")
        y = axpy_ref(x, y, a)
        return _launch(x, y, a)


    def axpy_no_raise(x, y, a):
        if x.device.type == "cpu":
            return axpy_ref(x, y, a)
        return _launch(x, y, a)


    def axpy_card_only(x, y, a):
        if not x.is_cuda:
            raise ValueError("axpy: card only")
        return _launch(x, y, a)


    def axpy_unchecked(x, y, a):
        if x.device.type == "cpu":
            return axpy_ref(x, y, a)
        if not x.is_cuda:
            raise ValueError("axpy: unsupported device")
        fn = _build.entry("axpy", "axpy_f64")
        fn(x.data_ptr(), y.data_ptr(), a, _build.stream_ptr(x))
        return y


    def plan(n):
        fn = _build.entry("axpy", "axpy_plan")
        return fn(n)
"""


def test_device_contract(tmp_path):
    """A wrapper that reaches a launch runs its plain version only on the
    CPU, raises on another device (itself or through the wrapper it
    delegates to), checks the entry's code, and has no fallback in a
    ``try``; a query of the card (no stream) is no wrapper, though every
    caller of an entry must check its code."""
    rpt = kernel_lint.lint_paths([_write(tmp_path, "wrappers.py",
                                         WRAPPERS)])
    assert _rules(rpt) == {"device-contract"}
    assert _symbols(rpt, "device-contract") == [
        "axpy_card_only", "axpy_fallback", "axpy_no_raise",
        "axpy_plain_on_card", "axpy_unchecked", "plan"]


CUDA_BAD = """
    #define BM 64
    static constexpr int kTile = 128;
    static constexpr int kBig = 300 * 1024;

    __global__ void sum_kernel(const double* x, double* out, int n) {
      float acc = 0.f;
      for (int i = 0; i < n; ++i) acc += (float)x[i];
      out[0] = acc;
    }

    __global__ void big_kernel(const double* x, double* out, int n) {
      extern __shared__ double buf[];
      double acc = 0.0;
      for (int i = 0; i < n; ++i) acc += x[i];
      out[0] = acc;
    }

    int launch(const double* x, double* out, int n, cudaStream_t stream) {
      const dim3 grid(n / BM, 1);
      sum_kernel<<<grid, 256, 0, stream>>>(x, out, n);
      sum_kernel<<<n / kTile, 256, 0, stream>>>(x, out, n);
      big_kernel<<<1, 256, 96 * 1024, stream>>>(x, out, n);
      cudaFuncSetAttribute(big_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kBig);
      return 0;
    }
"""
CUDA_OK = """
    #define BM 64
    static constexpr int kTile = 128;
    static constexpr int kMax = 227 * 1024;

    __global__ void sum_kernel(const double* x, double* out, int n) {
      double acc = 0.0;
      for (int i = 0; i < n; ++i) acc += x[i];
      out[0] = acc;
    }

    __global__ void softmax_kernel(const __nv_bfloat16* s, float* out, int n) {
      float acc = 0.f;
      for (int i = 0; i < n; ++i) acc += __bfloat162float(s[i]);
      out[0] = acc;
    }

    template <typename F>
    int raise_limit(F kernel, int bytes) {
      return (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    }

    int launch(const double* x, double* out, int n, size_t smem,
               cudaStream_t stream) {
      const dim3 grid((n + BM - 1) / BM, 1);
      sum_kernel<<<grid, 256, 16 * 1024, stream>>>(x, out, n);
      sum_kernel<<<(n + kTile - 1) / kTile, 256, 0, stream>>>(x, out, n);
      sum_kernel<<<(n + 31) / 32, 32, 0, stream>>>(x, out, n);
      cudaFuncSetAttribute(sum_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMax);
      sum_kernel<<<1, 256, smem, stream>>>(x, out, n);
      auto kernel = softmax_kernel;
      raise_limit(kernel, 100 * 1024);
      softmax_kernel<<<1, 256, 100 * 1024, stream>>>(nullptr, nullptr, n);
      return 0;
    }
"""


def test_grid_tail_smem_and_acc_fire_on_the_bad_source(tmp_path):
    """A floor-divided grid (``dim3`` and ``<<<>>>``), a launch over 48 KB
    without the attribute, an attribute over sm_90's 227 KB and a float
    accumulator in a double kernel are flagged; the clean twin (ceiling
    grids, the attribute set directly or through a helper on an alias, a
    request that cannot be sized, bf16's f32 softmax) is not."""
    bad = kernel_lint.lint_paths([_write(tmp_path, "bad.cu", CUDA_BAD)])
    assert _rules(bad) == {"grid-tail", "smem-footprint", "acc-dtype"}
    assert len([f for f in bad if f.rule == "grid-tail"]) == 2
    assert len([f for f in bad if f.rule == "smem-footprint"]) == 2
    assert [f.symbol for f in bad if f.rule == "acc-dtype"] == ["sum_kernel"]
    ok = kernel_lint.lint_paths([_write(tmp_path, "ok.cu", CUDA_OK)])
    assert len(ok) == 0, ok.render()


PY_KERNEL = """
    import torch

    BLOCK = 128


    def plan_bad(n):
        blocks = n // BLOCK
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        return blocks


    def plan_ok(n):
        blocks = -(-n // BLOCK)
        grid = (n + BLOCK - 1) // BLOCK
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return blocks, grid
"""


def test_python_grids_and_tf32(tmp_path):
    rpt = kernel_lint.lint_paths([_write(tmp_path, "plan.py", PY_KERNEL)])
    assert _rules(rpt) == {"grid-tail", "acc-dtype"}
    assert {f.symbol for f in rpt} == {"plan_bad"}
    assert len([f for f in rpt if f.rule == "acc-dtype"]) == 2


# ---------------------------------------------------- the port's own scope

def test_port_scope_is_clean_against_baseline():
    """The derived scope and the CUDA sources carry no finding beyond the
    committed baseline: the gate ``--check`` runs."""
    report = run()
    baseline = findings.load_baseline(BASELINE)
    assert baseline is not None
    new = report.new_against(baseline)
    assert not new, "\n".join(f.render() for f in new)


def test_baseline_entries_are_justified_and_live():
    """Every accepted finding says why, and is still found (a stale entry
    would accept a future regression under its name)."""
    baseline = json.loads(BASELINE.read_text())
    assert baseline["findings"]
    live = {f.key for f in run()}
    for f in baseline["findings"]:
        assert f["justification"] and "TODO" not in f["justification"], f
        assert (f["rule"], f["path"], f["symbol"]) in live, f


def test_kernel_lint_sees_the_ports_launches():
    """The thirteen launch sites that raise their dynamic shared memory
    limit are found with it, every grid of the sources rounds up, and no
    kernel that takes double accumulates in float."""
    text = "\n".join(p.read_text() for p in kernel_lint.kernel_sources()
                     if p.suffix == ".cu")
    assert text.count("cudaFuncAttributeMaxDynamicSharedMemorySize") >= 13
    rpt = kernel_lint.lint_paths(kernel_lint.kernel_sources())
    assert len(rpt) == 0, rpt.render()


def test_scaffolding_inventory_is_the_lm_zoo():
    scaffolding = imports.scaffolding_inventory()
    assert not any(m.startswith(tuple(imports.ROOT_PACKAGES))
                   for m in scaffolding)
    for m in ("repro_torch.models.transformer", "repro_torch.configs.base",
              "repro_torch.serving.decode", "repro_torch.launch.inputs",
              "repro_torch.configs.gemma3_4b", "repro_torch.configs.yi_34b"):
        assert m in scaffolding


def test_default_scope_tracks_imports():
    scope = {p.name for p in imports.default_scope()}
    assert {"engine.py", "scheduler.py", "sources.py", "cv.py", "grid.py",
            "study.py", "svm_suite.py", "seeding.py", "flash_attention.py",
            "jit_lint.py", "kernel_lint.py", "server.py"} <= scope
    assert "transformer.py" not in scope and "attention.py" not in scope


# -------------------------------------------------------------------- CLI

def test_plan_smoke_passes():
    report = findings.Report()
    plan_smoke(report)
    assert len(report) == 0, report.render()


def test_check_gates_on_new_findings(tmp_path, capsys):
    """``--check`` exits 0 on the tree against the committed baseline and 1
    on a bad fixture against an empty one; ``--write-baseline`` keeps a
    justification across a refresh."""
    assert main(["--check"]) == 0
    bad = _write(tmp_path, "timers.py", TIMER)
    empty = tmp_path / "none.json"
    assert main(["--check", "--paths", str(bad), "--baseline",
                 str(empty)]) == 1
    assert "NEW findings" in capsys.readouterr().out
    assert main(["--write-baseline", "--paths", str(bad), "--baseline",
                 str(empty)]) == 0
    data = json.loads(empty.read_text())
    data["findings"][0]["justification"] = "kept"
    empty.write_text(json.dumps(data))
    assert main(["--write-baseline", "--paths", str(bad), "--baseline",
                 str(empty)]) == 0
    assert json.loads(empty.read_text())["findings"][0]["justification"] \
        == "kept"
    assert main(["--check", "--paths", str(bad), "--baseline",
                 str(empty)]) == 0


@pytest.mark.parametrize("rule", ["timer-no-sync", "host-sync-cast",
                                  "host-sync-branch", "data-dependent-shape",
                                  "device-contract", "grid-tail",
                                  "smem-footprint", "acc-dtype"])
def test_each_rule_fires_through_the_cli(tmp_path, rule):
    """Each of the eight rules reaches ``--check``'s report from its
    fixture (the sync-free rules on a body the port lists: a copy of
    ``svm/engine.py::smo_chunk`` with a read of its done flag)."""
    files = {
        "timer-no-sync": ("timers.py", TIMER),
        "device-contract": ("wrappers.py", WRAPPERS),
        "grid-tail": ("bad.cu", CUDA_BAD),
        "smem-footprint": ("bad.cu", CUDA_BAD),
        "acc-dtype": ("bad.cu", CUDA_BAD),
    }
    if rule in files:
        path = _write(tmp_path, *files[rule])
    else:
        pkg = tmp_path / "repro_torch" / "svm"
        pkg.mkdir(parents=True)
        path = _write(pkg, "engine.py", """
            import torch


            def smo_chunk(source, y, train_mask, C, state, *, n_iters,
                          wss="2", tol=1e-3, it_cap=None):
                if bool(state.done):
                    return state
                while state.f.abs().max() > tol:
                    state = state
                idx = torch.nonzero(train_mask)
                return state, idx
        """)
    report = run([str(path)])
    assert rule in _rules(report)
