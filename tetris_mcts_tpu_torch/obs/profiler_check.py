"""How many launches torch.profiler records of a kernel it is asked to time.

chip_smoke.py times each hand-written kernel from torch.profiler's
device-side events of 20 launches. This script measures how often a session
records fewer: it grows the CLI's lp trees (B=64, 100 sims, 20 moves),
profiles 2 more moves with host and device activities (with
`--after_profile`, as chip_smoke.py does before its kernel timings), then
runs `--sessions` profiler sessions of 20 `select_walk` launches on the
trees in each of two forms, and prints one JSON line with each session's
count of recorded launches and mean device ms a launch:

- "plain": one profiled step, as a bare `torch.profiler.profile` block
  (the form chip_smoke.py uses);
- "warmup": a warm-up step of 20 launches, whose events the profiler
  drops, then the measured step of 20.

Run on a machine with a CUDA card:

    python -m tetris_mcts_tpu_torch.obs.profiler_check --sessions 15 [--after_profile]
"""

from __future__ import annotations

import argparse
import json

import torch

from tetris_mcts_tpu_torch.obs.card import device_label

KERNEL = "tmt::select_kernel("
REPS = 20


def _session(fn, warmup: bool):
    """(launches recorded, mean device ms a recorded launch or None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    sched = schedule(wait=0, warmup=1, active=1, repeat=1) if warmup else None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], schedule=sched) as prof:
        for _ in range(2 if warmup else 1):
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
            if warmup:
                prof.step()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and KERNEL in e.key]
    n = sum(e.count for e in rows)
    return n, (sum(e.self_device_time_total for e in rows) / 1e3 / n if n else None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sessions", type=int, default=15)
    p.add_argument("--after_profile", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_check: no CUDA device")
    from tetris_mcts_tpu_torch.ops import tree_walk
    from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayConfig, SelfPlayDriver
    from tetris_mcts_tpu_torch.search import mcts

    cfg = SelfPlayConfig(benchmark=True)
    driver = SelfPlayDriver(cfg, device="cuda", log=lambda s: None)
    driver.run(20)
    if args.after_profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            driver.run(2)
            torch.cuda.synchronize()
    tcfg = driver.search_cfg.tree
    gum, rnd = mcts.TorchPlanes(123, "cuda", tcfg.policy)(cfg.batch, tcfg.max_depth)
    sel = lambda: tree_walk.select_walk(driver.trees, gum, rnd, tcfg)
    sel()
    out = {form: [_session(sel, form == "warmup") for _ in range(args.sessions)]
           for form in ("plain", "warmup")}
    print(json.dumps({"reps": REPS, "after_profile": args.after_profile, "sessions": out,
                      "device": device_label(torch.device("cuda"))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
