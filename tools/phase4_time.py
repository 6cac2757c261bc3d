#!/usr/bin/env python3
"""Time phase 4 of a checkout's ``chip_smoke.py`` on one card, so that two
checkouts' phase 4 can be compared in one call (the host's speed varies
between machines).

    python3 tools/phase4_time.py ROOT [--cpu-steps N]

ROOT holds a ``chip_smoke.py`` and its ``lqer_tpu_torch`` package (for
example ``build/parent``, made with ``git archive``). The script builds
ROOT's kernels, runs its phase-4 functions as its ``main`` does (with the
pool of CPU workers where the script has one; ``--cpu-steps`` sets its
``CPU_STEPS``) and prints the card's line and the phase's wall time; any
failed check raises.
"""

import importlib
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    import torch

    root = Path(sys.argv[1]).resolve()
    cpu_steps = (int(sys.argv[sys.argv.index("--cpu-steps") + 1])
                 if "--cpu-steps" in sys.argv else None)
    sys.path.insert(0, str(root))      # the CPU workers import it by name
    cs = importlib.import_module("chip_smoke")
    if Path(cs.__file__).resolve() != root / "chip_smoke.py":
        raise RuntimeError(f"imported {cs.__file__}, not {root}")
    from lqer_tpu_torch.ops.kernels._build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{root}: card {card}; build {build_all():.1f}s", flush=True)
    t0 = time.perf_counter()
    if hasattr(cs, "CpuPool"):
        if cpu_steps is not None:
            cs.CPU_STEPS = cpu_steps
        print(f"{root}: CPU_STEPS {cs.CPU_STEPS}", flush=True)
        pool = cs.CpuPool()
        try:
            cs.phase_teacher_forced_mistral(torch, pool)
            cs.phase_teacher_forced(torch, pool)
            cs.phase_teacher_forced_opt(torch, pool)
            cs.phase_teacher_forced_opt(
                torch, pool, "facebook/opt-350m", ("bfloat16",),
                rms_limit=cs.LOGIT_RMS_STEPS_OPT350M)
        finally:
            failed = pool.finish(torch)
        if failed:
            raise AssertionError(f"phase 4 against the CPU: {failed}")
    else:
        cs.phase_teacher_forced(torch)
        cs.phase_teacher_forced_opt(torch)
        cs.phase_teacher_forced_opt(torch, "facebook/opt-350m", ("bfloat16",),
                                    rms_limit=cs.LOGIT_RMS_STEPS_OPT350M)
        cs.phase_teacher_forced_mistral(torch)
    print(f"{root}: phase 4 {time.perf_counter() - t0:.1f}s wall "
          f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
