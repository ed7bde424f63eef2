"""The LM's decode with a sequence-sharded cache on a gloo world of 8
ranks (a ``(2, 2, 2)`` mesh), against the reference's jitted decode on the
same weights and tokens and against the port's unsharded decode: the
``decode_32k`` layout (cache over ``('model',)``, batch over
``('pod', 'data')``) and the ``long_500k`` one (cache over all axes, batch
1, ``dp=()``).  Each token's K/V is written only on the rank whose slice
of S holds it, and the flash decode's collectives are all-reduces of the
partial statistics: no all-gather of the cache."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_common import ref_params, run_lm_world
from repro.configs import get_config as ref_config
from repro.models.api import build_model as ref_build
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention as att
from repro_torch.models.api import build_model
from repro_torch.util import tolerance_for

ARCHS = ["yi-9b", "nemotron-4-340b", "jamba-v0.1-52b", "rwkv6-7b"]
MAX_SEQ, STEPS, BATCH = 16, 6, 4
# the flash decode merges partial maxima and sums across ranks where the
# one-rank run reduces once; over 6 tokens of float32 logits (up to ~4 in
# magnitude): scale 10 over float32's 1e-5
SHARDED = tolerance_for(torch.float32, scale=10)
# against the reference: XLA's reduction order beside the sharded merge;
# the largest gap found is 5.9e-6 (jamba) over logits up to 3.7 in
# magnitude, well inside scale 10 (atol 1e-4 + rtol 1e-4), so
# the same scale holds
REFERENCE = tolerance_for(torch.float32, scale=10)
LAYOUTS = {"decode_32k": ("model",), "long_500k": ("pod", "data", "model")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_decode")
    inp, want, ref = {"decode": {}}, {}, {}
    for i, arch in enumerate(ARCHS):
        cfg = get_config(arch).reduced()
        rmodel = ref_build(ref_config(arch).reduced())
        tree = ref_params(rmodel, seed=i)
        rstep = jax.jit(lambda p, t, n, c, m=rmodel: m.decode(p, t, n, c))
        toks = np.random.default_rng(i).integers(
            1, cfg.vocab, (BATCH, STEPS)).astype(np.int32)
        inp["decode"][arch] = {"params": tree, "tokens": toks,
                               "batch": BATCH, "max_seq": MAX_SEQ}
        model = build_model(cfg, device="cpu")
        params = convert.lm_params(tree, cfg, device="cpu")
        for layout in LAYOUTS:
            b = 1 if layout == "long_500k" else BATCH
            cache = model.init_cache(b, MAX_SEQ)
            logits = []
            for pos in range(STEPS):
                lg, cache = model.decode(params, torch.as_tensor(
                    toks[:b, pos]), pos, cache)
                logits.append(lg.numpy())
            want[f"{arch}/{layout}"] = np.stack(logits, 1)
            rcache, logits = rmodel.init_cache(b, MAX_SEQ), []
            for pos in range(STEPS):
                lg, rcache = rstep(tree, jnp.asarray(toks[:b, pos]), pos,
                                   rcache)
                logits.append(np.asarray(lg))
            ref[f"{arch}/{layout}"] = np.stack(logits, 1)
    out, reports = run_lm_world(tmp, "decode", inp)
    return out, reports, want, ref


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_unsharded(world, arch, layout):
    out, _, want, _ = world
    key = f"{arch}/{layout}"
    np.testing.assert_allclose(out[key]["logits"], want[key], **SHARDED)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_reference(world, arch, layout):
    out, _, _, ref = world
    key = f"{arch}/{layout}"
    np.testing.assert_allclose(out[key]["logits"], ref[key], **REFERENCE)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tokens_written_only_on_owning_rank(world, layout):
    _, reports, _, _ = world
    names = ("pod", "data", "model")
    for arch in ("yi-9b", "nemotron-4-340b", "jamba-v0.1-52b"):
        seen = set()
        for rep in reports:
            r = rep[f"{arch}/{layout}"]
            coord = dict(zip(names, r["coord"]))
            idx = 0
            for a in LAYOUTS[layout]:
                idx = idx * 2 + coord[a]
            for path, w in r["written"].items():
                start = idx * w["s_loc"]
                mine = [p - start for p in range(STEPS)
                        if start <= p < start + w["s_loc"]]
                assert w["nonzero"] == mine, (arch, layout, path, idx)
                seen |= {p + start for p in w["nonzero"]}
        assert seen == set(range(STEPS)), (arch, layout)


def test_flash_decode_moves_only_partials(world):
    out, reports, _, _ = world
    q, kc, vc = (torch.as_tensor(x) for x in out["attention/inputs"])
    want = att.decode_attention(q, kc, vc, 11).numpy()
    for n in (1, 3):
        np.testing.assert_allclose(out[f"attention/{n}"], want, **SHARDED)
        for rep in reports:
            counts = rep[f"attention/{n}"]["counts"]
            assert set(counts) == {"all_reduce"}, counts
            # a MAX and two SUMs on each of the n seq axes
            assert counts["all_reduce"] == 3 * n, counts
