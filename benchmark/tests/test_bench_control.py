"""The control comes out not correct: the reference one precision below the
configuration's (int4 linears under int8, fp8 matmul inputs under bf16), put
in the program's place, reads above the cell's limit, where the program reads
under it.  On the card it was read at the cells' own sizes
(tools/calibrate.py); here at every published width with two layers and a
small frame."""

import pytest

from benchmark import harness
from benchmark.tests.conftest import NARROW, cut
from benchmark.tools.calibrate import CONTROL

DRIVER = harness.load_file(harness.BENCH_DIR / "drivers" / "denoise.py", "denoise_driver")
CELLS = {"int8_384.denoise": "tc5b-int8-384x672", "bf16_576.denoise": "tc5b-bf16-576x1024"}


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_fails_the_limit(workload):
    cfg = cut(CELLS[workload], **NARROW)
    limit = harness.limits_of(workload)["update_rel_err"]
    d = DRIVER.Driver(cfg, harness.mix_of("denoise"), 2 ** 35 + 1, "cpu")
    d.call(0)
    ref = d.follow(d.reference_model(), 0)[0]
    control = d.follow(d.reference_model(CONTROL[cfg["quant"]]), 0)[0]
    assert d.gap(d.outputs[0], ref, 0) <= limit < d.gap(control, ref, 0)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_guidance_err_sees_a_branch_left_out(workload, monkeypatch):
    """A step whose CFG batch keeps one branch misses about all of the
    guidance term (scale / (scale - 1) of it), above the limit; a sound one
    reads under it."""
    from benchmark.faults import half_batch

    cfg = cut(CELLS[workload], **NARROW)
    limit = harness.limits_of(workload)["guidance_err"]
    mix = harness.mix_of("denoise")
    d = DRIVER.Driver(cfg, mix, 2 ** 35 + 3, "cpu")
    d.call(0)
    half_batch(monkeypatch.setattr)
    bad = DRIVER.Driver(cfg, mix, 2 ** 35 + 3, "cpu")
    bad.call(0)
    ref, term = d.expected(0)
    scale = cfg["guidance_scale"]
    assert d.guidance_gap(d.outputs[0], ref, term) <= limit
    assert abs(d.guidance_gap(bad.outputs[0], ref, term) - scale / (scale - 1)) < 0.1
