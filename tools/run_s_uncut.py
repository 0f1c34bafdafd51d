"""Run S uncut: chip_smoke.py's phase 5s at run A's 49 frames and 5 Euler
steps a depth window, against run A itself (the smoke cuts run S to 9
frames and 1 step for its clock and holds it against run A9).

    python tools/run_s_uncut.py     # from the root of a checkout; one card

Runs chip_smoke.py's device, build and main-path phases (runs A-D, A9),
frees their models, then run S's four ranks by torchrun on the one card
over gloo, with every check of phase 5s.  Its seconds are not a speed
figure: the ranks time-share the card and stage their hops through host
memory.
"""

import gc
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> None:
    os.chdir(REPO)
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as smoke

    smoke.phase_device()
    smoke.run_phase("build", smoke.phase_build)
    tc, runs, models = smoke.run_phase("5 main path", smoke.phase_main_path)
    del tc, models
    gc.collect()
    torch.cuda.empty_cache()
    smoke.run_phase("5s sharded, 49 frames", smoke.phase_sharded, runs, False)
    smoke.log(f"phases {smoke.PHASE_SECONDS}")


if __name__ == "__main__":
    main()
