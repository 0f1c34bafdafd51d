"""The work counters against the bound column of PERF.md's kernel table."""

import pytest

from benchmark import work
from benchmark.tests.conftest import cut


def op(cfg, name):
    return next(o for o in work.dit_step_ops(cfg) if o.name == name)


@pytest.mark.parametrize("config, tokens, ms", [("tc5b-int8-384x672", 13330, 4.42),
                                                ("tc5b-bf16-576x1024", 30178, 22.63)])
def test_k1_bound(config, tokens, ms):
    cfg = cut(config)
    assert work.token_counts(cfg)["joint"] == tokens
    attn = op(cfg, "block.self_attention")
    assert attn.least_s / attn.count * 1e3 == pytest.approx(ms, abs=0.005)


def test_k2b_ff1_and_perceiver_bounds():
    cfg = cut("tc5b-int8-384x672")
    ff1 = op(cfg, "block.ff.proj_in")
    assert ff1.kind == "int8" and ff1.least_s / ff1.count * 1e3 == pytest.approx(1.017, abs=5e-4)
    perceiver = op(cfg, "perceiver.attention")
    assert perceiver.count == 21
    assert perceiver.least_s / perceiver.count * 1e3 == pytest.approx(0.656, abs=5e-4)


def test_bf16_config_counts_no_int8():
    cfg = cut("tc5b-bf16-576x1024")
    assert {o.kind for o in work.dit_step_ops(cfg)} == {"bf16"}
    # 1.62 PFLOP a CFG step at 30,178 joint tokens
    assert sum(o.ops * o.count for o in work.dit_step_ops(cfg)) == pytest.approx(1.62e15, rel=0.01)
