"""Public wrappers for the port's kernels, and their launch counts.

Mirrors ``src/repro/kernels/ops.py``. Each wrapper launches its CUDA kernel
on a CUDA tensor (or raises) and runs its plain PyTorch version
(``ref.py``) on a CPU tensor; a kernel's count grows by its launches only.
``smo_chunk`` counts the dense chunk kernels' launches at one lane and over
lanes, on all four of their routes. ``smo_stream_chunk`` counts its
one-launch kernels' launches (the cluster and the persistent routes'); on
its pair route it adds its launches of
the WSS-1 selection kernel to ``smo_select`` and of the fused step to
``fused_smo_step``.
``smo_chunk_sources`` and ``smo_stream_chunk_sources`` are the same chunks
over lanes that each carry their own operands (the shrinking scheduler's
compact lanes); they count on their own names, split by route like
``smo_chunk`` and ``smo_stream_chunk``, and the latter's pair route adds
its selection and fused launches to ``smo_select`` and ``fused_smo_step``.
``water_fill``, ``sir_greedy``, ``ato_system_lanes`` / ``ato_apply_lanes``
(ATO's ramp step, one lane or a row) and ``avg_spill`` / ``top_spill``
(the LOO seeders' spills; their fused entries ``avg_spill_loo`` /
``top_spill_loo`` count on them) count one per launch.
``flash_attention`` counts one per launch (one per prefill attention layer
on the LM serving path), ``selective_scan`` likewise (one per mamba layer
in a prefill and in a decode step), ``mlstm_parallel`` one per mLSTM layer
in a prefill (decode is the reference's recurrent update in torch ops),
``slstm_scan`` one per sLSTM layer in a prefill and in a decode step, and
``window_counts`` splits
``flash_attention``'s launches into windowed (a sliding-window layer's)
and global ones. ``route_counts``
splits the twelve kernels that have routes: ``rbf_kernel_matrix`` (tensor,
the FP64 tensor cores / fma), ``smo_chunk`` (one_block, the resident
kernel / multi_block / cluster / one_block_global, the global-state
kernel), ``smo_stream_chunk`` (pair / persistent / cluster: the chunks
on each), ``smo_chunk_sources`` and ``smo_stream_chunk_sources`` (the same
routes, over lanes with their own operands; the cluster route takes none
of the latter's), ``flash_attention`` (wgmma / mma /
fma), ``ato_system_lanes`` (compact / carried: a ramp's later steps),
``ato_apply_lanes`` (split / fused: the ramp's, with the alpha update),
``avg_spill`` and ``top_spill`` (fused: the seeder's prologue, order
and spill in one launch / split: the spill alone), ``mlstm_parallel``
(wgmma, bf16 at head dim 384 / mma, bf16 / fma, float32) and
``slstm_scan`` (cluster: 16 blocks a
batch row, rz in their registers / block: one block a batch row).
"""
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mlstm import mlstm_parallel
from repro_torch.kernels.rbf import rbf_kernel_matrix
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.kernels.seeding import (ato_apply_lanes, ato_system_lanes,
                                         avg_spill, avg_spill_loo,
                                         sir_greedy, top_spill,
                                         top_spill_loo, water_fill)
from repro_torch.kernels.slstm import slstm_scan
from repro_torch.kernels.smo_chunk import (smo_chunk, smo_chunk_lanes,
                                           smo_chunk_sources, smo_select,
                                           smo_stream_chunk,
                                           smo_stream_chunk_sources)
from repro_torch.kernels.smo_step import fused_smo_step
from repro_torch.kernels.smo_update import smo_f_update

__all__ = ["rbf_kernel_matrix", "smo_f_update", "smo_chunk",
           "smo_chunk_lanes", "smo_chunk_sources", "smo_stream_chunk",
           "smo_stream_chunk_sources", "smo_select",
           "fused_smo_step", "flash_attention", "water_fill",
           "sir_greedy", "ato_system_lanes", "ato_apply_lanes", "avg_spill",
           "avg_spill_loo", "top_spill", "top_spill_loo", "selective_scan",
           "mlstm_parallel", "slstm_scan", "launch_counts",
           "reset_launch_counts", "route_counts", "window_counts"]

#: kernel name -> the wrapper that carries its count
KERNELS = {"rbf_kernel_matrix": rbf_kernel_matrix,
           "smo_f_update": smo_f_update,
           "smo_chunk": smo_chunk,
           "smo_chunk_sources": smo_chunk_sources,
           "fused_smo_step": fused_smo_step,
           "smo_select": smo_select,
           "smo_stream_chunk": smo_stream_chunk,
           "smo_stream_chunk_sources": smo_stream_chunk_sources,
           "flash_attention": flash_attention,
           "water_fill": water_fill,
           "sir_greedy": sir_greedy,
           "ato_system_lanes": ato_system_lanes,
           "ato_apply_lanes": ato_apply_lanes,
           "avg_spill": avg_spill,
           "top_spill": top_spill,
           "selective_scan": selective_scan,
           "mlstm_parallel": mlstm_parallel,
           "slstm_scan": slstm_scan}


def launch_counts() -> dict[str, int]:
    """{kernel name: launches since the last reset}."""
    return {name: w.launches for name, w in KERNELS.items()}


#: the wrappers whose launches split into routes
ROUTED = {"rbf_kernel_matrix": rbf_kernel_matrix, "smo_chunk": smo_chunk,
          "smo_chunk_sources": smo_chunk_sources,
          "smo_stream_chunk": smo_stream_chunk,
          "smo_stream_chunk_sources": smo_stream_chunk_sources,
          "flash_attention": flash_attention,
          "ato_system_lanes": ato_system_lanes,
          "ato_apply_lanes": ato_apply_lanes,
          "avg_spill": avg_spill,
          "top_spill": top_spill,
          "mlstm_parallel": mlstm_parallel,
          "slstm_scan": slstm_scan}


def route_counts() -> dict[str, dict[str, int]]:
    """{kernel name: {route: launches since the last reset}}."""
    return {name: dict(w.route_launches) for name, w in ROUTED.items()}


def window_counts() -> dict[str, int]:
    """{"windowed": ..., "global": ...}: ``flash_attention``'s launches
    with a window and without one since the last reset."""
    return dict(flash_attention.window_launches)


def reset_launch_counts() -> None:
    for w in KERNELS.values():
        w.launches = 0
    for w in ROUTED.values():
        w.route_launches = dict.fromkeys(w.route_launches, 0)
    flash_attention.window_launches = dict.fromkeys(
        flash_attention.window_launches, 0)
