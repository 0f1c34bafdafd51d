"""The worlds of the port's sharded runs on the CPU: how a failed rank
ends one (tests/torch_worlds.py ``run_world``; parallel/distributed.py
``GROUP_TIMEOUT`` of the mesh's groups), and how ranks that share a device
plan the VAE decode (pipelines/trajcrafter.py ``decode``: the device's
memory over the mesh's ranks on it, ``distributed.ranks_on_device``).

Two small gloo worlds (the ranks' side is tests/torch_worlds.py
``fail_at_once`` and tests/torch_parallel_workers.py
``mesh_groups_and_decode``).  The decode runs the
tiny dev pipeline under tp 2 (a plane of one rank, so only the sharing of
the device divides the estimate) on latents (1, 3, 9, 12, 4) under a
planted memory of 1.5x what the one-shot estimate needs: one rank alone
decodes in one shot, two on one device in strips.
"""

import time
from datetime import timedelta

import numpy as np
import pytest
import torch
from torch_parallel_workers import mesh_groups_and_decode
from torch_worlds import JOIN_TIMEOUT, fail_at_once, run_world

from trajectorycrafter_tpu_torch.config import TrajCrafterConfig
from trajectorycrafter_tpu_torch.models import vae as vae_mod
from trajectorycrafter_tpu_torch.orchestrator import build_dev_models
from trajectorycrafter_tpu_torch.parallel import distributed as D
from trajectorycrafter_tpu_torch.pipelines import trajcrafter

torch.set_num_threads(1)
# a failed rank's error comes back within this many seconds of the call
# (the ranks' start included), not after JOIN_TIMEOUT
FAILED_WORLD_SECONDS = 15.0
LATENTS = np.random.default_rng(3).standard_normal((1, 3, 9, 12, 4)).astype(np.float32)
ESTIMATE = 9 * 72 * 96 * 128 * 2 * 3.5  # vae.py's one-shot peak estimate of LATENTS
MEMORY = int(1.5 * ESTIMATE / 0.6)  # one rank fits; two sharing the device do not
MESH = (1, 1, 2)


def test_a_failed_rank_ends_the_world_at_once(tmp_path):
    """Rank 1 raises at once while ranks 0 and 2 wait as if for a peer:
    ``run_world`` ends them and raises with rank 1's error first."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 first") as failed:
        run_world(fail_at_once, 3, tmp_path, 1, 10 * JOIN_TIMEOUT)
    seconds = time.monotonic() - t0
    assert "planted failure on rank 1" in str(failed.value)
    assert seconds < FAILED_WORLD_SECONDS, seconds


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(mesh_groups_and_decode, 2, tmp_path_factory.mktemp("groups"), MESH,
                     LATENTS, MEMORY)


def test_the_mesh_groups_wait_well_under_the_world_timeout(world):
    assert D.GROUP_TIMEOUT <= D.TIMEOUT / 4
    for run in world:
        assert run["timeouts"] and all(t == D.GROUP_TIMEOUT for t in run["timeouts"])
        assert isinstance(run["timeouts"][0], timedelta)


def _one_rank_routes():
    cfg = TrajCrafterConfig()
    cfg.diffusion.quant = "none"
    pipe = build_dev_models(cfg, "cpu").pipeline
    routes, tiled = [], vae_mod.vae_decode_tiled
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trajcrafter, "decode_memory_bytes", lambda device: MEMORY)
        mp.setattr(vae_mod, "vae_decode_tiled",
                   lambda *a, **kw: routes.append("strips") or tiled(*a, **kw))
        pipe.decode(torch.from_numpy(LATENTS))
    return pipe.device_ranks, routes


def test_ranks_sharing_a_device_plan_the_decode_in_their_share(world):
    """Two ranks on one device (the CPU here, one card on the H100 machine)
    each plan in half its memory and decode in strips; one rank alone,
    unsharded, decodes the same latents in one shot under the same memory.
    Given a card each, the ranks count one rank a device."""
    assert vae_mod.decode_is_tiled(LATENTS.shape, MEMORY // 2)
    assert not vae_mod.decode_is_tiled(LATENTS.shape, MEMORY)
    alone, routes = _one_rank_routes()
    assert alone == 1 and routes == []
    for run in world:
        assert run["device_ranks"] == 2 and run["own_cards"] == 1
        assert run["routes"] == ["strips"]
