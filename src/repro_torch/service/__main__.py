"""Run the study daemon: one shared LanePool serving plans over a local
socket until SIGTERM / SIGINT or a client's ``shutdown`` (both drain: the
studies in flight flush snapshots and resume on the next start).

    PYTHONPATH=src python -m repro_torch.service --socket /tmp/study.sock \\
        --checkpoint-root /tmp/study-ckpt --max-width 4

Mirrors ``scripts/study_serve.py``, plus ``--device`` (``cuda`` unless
``cpu`` is asked for). The flags fix the pool's result-affecting contract
(tol, wss, shrink settings), which submitted plans must match, and the
schedule shape (width, chunk size, budgets), which served plans inherit.
"""
import argparse
import signal
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--socket", required=True,
                    help="AF_UNIX socket path to listen on")
    ap.add_argument("--checkpoint-root", default=None,
                    help="root directory for per-(tenant, plan) study "
                    "snapshots (omit to disable resume)")
    ap.add_argument("--device", default=None,
                    help="torch device of the pool (default: cuda)")
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--wss", default="2", choices=("1", "2"))
    ap.add_argument("--chunk-iters", type=int, default=4096)
    ap.add_argument("--lane-quantum", type=int, default=4)
    ap.add_argument("--max-width", type=int, default=None,
                    help="width cap (default: measured cost model)")
    ap.add_argument("--max-resident", type=int, default=0,
                    help="kernel-source residency budget, count (0=off)")
    ap.add_argument("--cache-bytes", type=int, default=0,
                    help="kernel-source residency budget, bytes (0=off)")
    ap.add_argument("--shrink-every", type=int, default=0)
    ap.add_argument("--shrink-quantum", type=int, default=128)
    ap.add_argument("--snapshot-every", type=int, default=1,
                    help="study snapshot period in pool chunks")
    ap.add_argument("--plan-chunk-budget", type=int, default=0,
                    help="per-plan admission budget: max-bound simulated "
                    "lane-chunks (0=unbounded)")
    ap.add_argument("--plan-bytes-budget", type=int, default=0,
                    help="per-plan admission budget: max-bound simulated "
                    "peak resident bytes (0=unbounded)")
    args = ap.parse_args(argv)

    from repro_torch.service import StudyServer, StudyService

    service = StudyService(
        tol=args.tol, wss=args.wss, chunk_iters=args.chunk_iters,
        lane_quantum=args.lane_quantum, max_width=args.max_width,
        max_resident=args.max_resident, cache_bytes=args.cache_bytes,
        shrink_every=args.shrink_every, shrink_quantum=args.shrink_quantum,
        checkpoint_root=args.checkpoint_root,
        snapshot_every=args.snapshot_every,
        plan_chunk_budget=args.plan_chunk_budget,
        plan_bytes_budget=args.plan_bytes_budget, device=args.device)
    server = StudyServer(args.socket, service)

    def _drain(signum, frame):
        print(f"signal {signum}: draining", file=sys.stderr)
        server.stop_accepting()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    print(f"study daemon listening on {args.socket} "
          f"(device={service.device}, width={service.pool.max_width}, "
          f"tol={service.pool.tol}, wss={service.pool.wss})",
          file=sys.stderr)
    server.serve_forever()
    print("study daemon drained", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
