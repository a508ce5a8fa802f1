#!/usr/bin/env python3
"""chip_smoke.py phase 16 (the overload-control plane under an open-loop
flash crowd) with the crowd's peak raised past the phase's 3 C, on one
CUDA card: the check that an overload which starves the host is not read
as a sick card (the breaker stays closed; expiries answer the deadline).

    python3 tools/torch_load_stress.py PEAK OUTDIR

PEAK is a multiple of C ("6" is 6 C) or, with a leading "@", an absolute
rate in requests/s ("@3200"). The base rate stays 0.5 C. Run from the
repo root; prints what phase 16 prints and exits as it does (every check
of the phase applies). The servers' logs go to OUTDIR, and each server's
exit code is printed when the phase ends it."""
import os
import sys

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402


def main():
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    peak_arg, out = sys.argv[1], os.path.abspath(sys.argv[2])
    os.makedirs(out, exist_ok=True)
    from cedar_tpu_torch.load import flash_crowd_schedule, poisson_schedule

    def load_schedule(C, pool, seed):
        peak = float(peak_arg[1:]) if peak_arg.startswith("@") else float(peak_arg) * C
        due = flash_crowd_schedule(0.5 * C, peak, 2.0, 3.0, 16.0, seed=seed)
        due += [16.0 + t for t in poisson_schedule(0.5 * C, 4.0, seed=f"{seed}:tail")]
        draw = chip_smoke.load_mix(pool, seed)
        return [(t, draw()) for t in due]

    class Logged(chip_smoke.Webhook):
        def __init__(self, cfg, tmp, name, *a, **k):
            super().__init__(cfg, out, name, *a, **k)

        def kill(self):
            print(f"stress: server {os.path.basename(self.log_path)} exit code before kill: "
                  f"{self.proc.poll()}", flush=True)
            super().kill()

    chip_smoke.Webhook = Logged
    chip_smoke.load_schedule = load_schedule
    sys.argv = ["chip_smoke.py", "--only-load"]
    chip_smoke.main()


if __name__ == "__main__":
    main()
