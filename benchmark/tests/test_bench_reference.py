"""The frozen reference against the port's plain path (float32, no kernels) on
the same inputs: they agree to float32 rounding, so what the cell's check
reads of a sound run is the program's own precision."""

import pytest

from benchmark import harness
from benchmark.tests.conftest import NARROW, TINY, cut

DRIVER = harness.load_file(harness.BENCH_DIR / "drivers" / "denoise.py", "denoise_driver")


def plain_gap(cfg, seed=3):
    cfg = dict(cfg, dtype="float32", attention_impl="reference")
    d = DRIVER.Driver(cfg, harness.mix_of("denoise"), seed, "cpu")
    for m in d.pipe.transformer.modules():
        if hasattr(m, "int8_impl"):
            m.int8_impl = "reference"
    d.call(0)
    return d.gap(d.outputs[0], d.follow(d.reference_model(), 0)[0], 0)


@pytest.mark.parametrize("config", ["tc5b-int8-384x672", "tc5b-bf16-576x1024"])
def test_reference_is_the_plain_path_tiny(config):
    assert plain_gap(cut(config, **TINY)) <= 1e-5


def test_reference_is_the_plain_path_at_published_widths():
    # two of the 42 layers, a 64x96 frame; every width as published
    assert plain_gap(cut("tc5b-bf16-576x1024", **NARROW)) <= 1e-4


def test_rope_tables_are_the_ports():
    import numpy as np

    from benchmark.reference.dit import rope_tables
    from trajectorycrafter_tpu_torch.ops.rope import rope_for_sample

    for size in ((384, 672), (576, 1024)):
        cos, sin = rope_tables(64, *size, 13, 2)
        ref_cos, ref_sin = rope_for_sample(64, *size, 13)
        assert np.array_equal(cos.numpy(), ref_cos) and np.array_equal(sin.numpy(), ref_sin)
