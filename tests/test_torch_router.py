"""The prefix-affinity router in the port, held against the JAX package.

Plain Python on both sides: the same seeded hint sets, backlogs and
prompts go through both routers under each policy and every decision
(replica, matched pages, reason, fetch hint) must be JAX's; the digest
chain a router hashes a prompt to is both prefix caches' chain, and a
replica's published hint (``export_digests``) is JAX's for the same
index.  The subprocess mode's ``fetch_remote_hints`` raises, naming its
ROADMAP item.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.ragged.prefix_cache import \
    PrefixCache as JPrefixCache
from deepspeed_tpu.serving import router as jrouter
from deepspeed_tpu_torch.inference.v2.ragged.prefix_cache import \
    PrefixCache as TPrefixCache
from deepspeed_tpu_torch.serving import router as trouter

PAGE = 16
LABELS = ("r0", "r1", "r2", "r3")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _traffic(seed):
    """Prompts over four roots (shared prefixes of 1-4 pages), hints that
    hold random leading runs of their chains, random backlogs, pins."""
    rng = np.random.default_rng(seed)
    roots = [rng.integers(0, 1000, PAGE * 4) for _ in range(4)]
    prompts = []
    for _ in range(24):
        root = roots[rng.integers(0, 4)]
        keep = int(rng.integers(0, 5)) * PAGE
        prompts.append(np.concatenate(
            [root[:keep], rng.integers(0, 1000, int(rng.integers(1, 40)))]
        ).astype(np.int32))
    return rng, roots, prompts


def _decisions(mod, policy, seed, margin):
    rng, roots, prompts = _traffic(seed)
    r = mod.PrefixAffinityRouter(PAGE, top_k=8, policy=policy,
                                 fetch_backlog_margin=margin)
    for label in LABELS:
        hint = []
        for root in roots:
            chain = r.prompt_digests(root)
            hint += chain[:int(rng.integers(0, len(chain) + 1))]
        rng.shuffle(hint)
        r.publish(label, hint)
    r.pin(r.prompt_digests(roots[3])[0], "r2")
    out = []
    for i, prompt in enumerate(prompts):
        backlogs = {lb: int(rng.integers(0, 5)) for lb in LABELS
                    if not (i == 12 and lb == "r2")}
        d = r.decide(prompt, backlogs)
        out.append((d.label, d.matched_pages, d.reason, d.fetch_from,
                    list(d.fetch_digests)))
        if i == 16:
            r.forget("r1")
    out.append([r.hottest_group(lb) for lb in LABELS])
    return out


@pytest.mark.parametrize("margin", [-1, 0, 2])
@pytest.mark.parametrize("policy", trouter.POLICIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_decisions_equal_jax(policy, seed, margin):
    assert trouter.POLICIES == jrouter.POLICIES
    got = _decisions(trouter, policy, seed, margin)
    assert got == _decisions(jrouter, policy, seed, margin)
    if policy == "affinity":
        assert {g[2] for g in got[:-1]} >= {"affinity", "backlog"}


@pytest.mark.parametrize("seed", [0, 3])
def test_the_digest_chain_is_both_prefix_caches(seed):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, 32000, PAGE * 5 + 7).astype(np.int32)
    got = trouter.PrefixAffinityRouter(PAGE).prompt_digests(prompt)
    assert got == jrouter.PrefixAffinityRouter(PAGE).prompt_digests(prompt)
    d, want = b"", []
    for i in range(5):
        d = TPrefixCache.chain(d, prompt[i * PAGE:(i + 1) * PAGE])
        assert d == JPrefixCache.chain(
            bytes.fromhex(want[-1]) if want else b"",
            prompt[i * PAGE:(i + 1) * PAGE])
        want.append(d.hex())
    assert got == want
    # a replica's published hint: most recent first, bounded, as JAX's
    tcache, jcache = TPrefixCache(PAGE), JPrefixCache(PAGE)
    for page, digest in enumerate(want):
        for c in (tcache, jcache):
            c.insert(bytes.fromhex(digest), page + 1)
    for c in (tcache, jcache):
        c.touch_page(2)
    for k in (0, 3, 8):
        assert tcache.export_digests(k) == jcache.export_digests(k)
    assert tcache.export_digests(3)[0] == want[1]


def test_router_refusals_equal_jax():
    for mod in (trouter, jrouter):
        with pytest.raises(ValueError, match="page_size"):
            mod.PrefixAffinityRouter(0)
        with pytest.raises(ValueError, match="policy"):
            mod.PrefixAffinityRouter(PAGE, policy="random")
        with pytest.raises(ValueError, match="no live replicas"):
            mod.PrefixAffinityRouter(PAGE).decide([1, 2, 3], {})
    assert trouter.PrefixAffinityRouter(PAGE).prompt_digests(
        np.arange(PAGE - 1)) == []
    # an unreachable replica raises in both packages (port 1 refuses)
    for mod in (trouter, jrouter):
        with pytest.raises(OSError):
            mod.fetch_remote_hints("127.0.0.1:1", timeout_s=2.0)
