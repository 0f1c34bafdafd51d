"""Sweep preset orbit poses with one model stack, on the card.

    python -m trajectorycrafter_tpu_torch.scripts.inference_orbits \
        --video_path clip.mp4 [--test_run]

The port's counterpart of the root ``inference_orbits.py``: ``infer_gradual``
toward each of ``ORBIT_VARIANTS`` (``--test_run``: the first only), each into
``<run dir>/<variant>/``.  Unsharded, a variant that fails prints its
traceback and the sweep goes on, as the root script does.  Under
``--mesh_dp/--mesh_sp/--mesh_tp`` (torchrun, as cli.py) every variant runs
sharded with one model stack, the leader alone makes the directories and
prints, and an exception on any rank ends the run with a non-zero exit: a
rank that caught it and went on would leave the others waiting in a
collective.

    torchrun --nproc_per_node 4 -m trajectorycrafter_tpu_torch.scripts.inference_orbits \
        --mesh_sp 2 --mesh_tp 2 --video_path clip.mp4 [--dist_backend gloo]
"""

from __future__ import annotations

import os
import time
import traceback

from trajectorycrafter_tpu_torch.cli import (
    config_from_args,
    entry_world,
    get_parser,
    require_card,
)
from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter, check_supported

# target poses (theta, phi, r, x, y) of the reference's orbit presets
ORBIT_VARIANTS = {
    "left30": (0.0, -30.0, 0.0, 0.0, 0.0),
    "left45": (0.0, -45.0, 0.0, 0.0, 0.0),
    "left90": (0.0, -90.0, 0.0, 0.0, 0.0),
    "right30": (0.0, 30.0, 0.0, 0.0, 0.0),
    "right45": (0.0, 45.0, 0.0, 0.0, 0.0),
    "right90": (0.0, 90.0, 0.0, 0.0, 0.0),
    "top30": (30.0, 0.0, 0.0, 0.0, 0.0),
    "top45": (45.0, 0.0, 0.0, 0.0, 0.0),
}


def main(argv=None):
    parser = get_parser()
    parser.add_argument("--test_run", action="store_true",
                        help="run the first variant only")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    cfg.render.camera = "target"
    cfg.render.mode = "gradual"
    check_supported(cfg)
    require_card()

    with entry_world(cfg, args.dist_backend) as leader:
        tc = TrajCrafter(cfg)  # one stack for every variant
        say = print if leader else (lambda *a, **k: None)
        variants = dict(list(ORBIT_VARIANTS.items())[:1]) if args.test_run else ORBIT_VARIANTS
        base_dir = cfg.save_dir
        for name, pose in variants.items():
            t0 = time.time()
            try:
                cfg.render.target_pose = pose
                cfg.save_dir = os.path.join(base_dir, name)
                if leader:
                    os.makedirs(cfg.save_dir, exist_ok=True)
                tc.infer_gradual()
                say(f"[orbit {name}] done in {time.time() - t0:.1f}s")
            except Exception:
                if tc.mesh is not None:
                    raise
                # one variant's failure does not stop the unsharded sweep
                traceback.print_exc()
                print(f"[orbit {name}] FAILED after {time.time() - t0:.1f}s")
        cfg.save_dir = base_dir
    return list(variants)


if __name__ == "__main__":
    main()
