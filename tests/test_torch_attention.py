"""The port's ``chunked_attention`` (global and sliding-window, logits capped
or not, masked or banded) against the JAX package's on the CPU, float32,
on the same inputs made with numpy.  Tolerances are tests/test_attention.py's:
rtol 1e-4, atol 1e-5.

The sweep: window None, 4, 8 and 40; softcap None and 30; banded off and
on; GQA (4 query heads on 2 KV heads); 50 query rows in chunks of 16, so
the last chunk is ragged and the band (and its front padding) engages.
Then the decode form: one query row against a cache, with a scalar and a
per-row ``q_offset`` and ``kv_valid_len``, with and without a window.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.attention import (  # noqa: E402
    chunked_attention as jax_chunked)
from repro_torch.models.attention import chunked_attention  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _qkv(rng, B=2, S=50, H=4, Hk=2, D=16, T=None):
    T = T or S
    return (rng.standard_normal((B, S, H, D), dtype=np.float32),
            rng.standard_normal((B, T, Hk, D), dtype=np.float32),
            rng.standard_normal((B, T, Hk, D), dtype=np.float32))


def _both(q, k, v, jkw, tkw):
    theirs = jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         **jkw)
    mine = chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **tkw)
    return np.asarray(theirs), mine.numpy()


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("window", [None, 4, 8, 40])
def test_prefill_matches_jax(window, softcap, banded):
    """50 rows in chunks of 16 (the last one ragged); a band of 32 keys for
    windows 4 and 8, of 64 for 40."""
    q, k, v = _qkv(np.random.default_rng(7))
    kw = dict(causal=True, window=window, softcap=softcap, chunk=16,
              banded=banded)
    theirs, mine = _both(q, k, v, kw, kw)
    assert mine.shape == (2, 50, 4, 16)
    np.testing.assert_allclose(mine, theirs, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window", [4, 40])
def test_banded_equals_masked(window):
    """The band is exact: banded and masked agree on the port's side."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.default_rng(8),
                                                 S=96))
    kw = dict(causal=True, window=window, chunk=16)
    np.testing.assert_allclose(
        chunked_attention(q, k, v, banded=True, **kw).numpy(),
        chunked_attention(q, k, v, banded=False, **kw).numpy(),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_one_chunk_and_no_causal_mask_match_jax(softcap):
    """Fewer rows than a chunk (no band, whatever the flag); and the full
    (non-causal) mask, with more keys than queries."""
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, S=12)
    kw = dict(causal=True, window=4, softcap=softcap, chunk=16, banded=True)
    np.testing.assert_allclose(*_both(q, k, v, kw, kw)[::-1], rtol=RTOL,
                               atol=ATOL)
    q, k, v = _qkv(rng, S=20, T=33)
    kw = dict(causal=False, softcap=softcap, chunk=16)
    np.testing.assert_allclose(*_both(q, k, v, kw, kw)[::-1], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_matches_jax(per_row, window, softcap):
    """One query row against a cache of 64 (a local layer's is full length,
    masked by the window), at a scalar length or at per-row lengths 10 and
    40."""
    q, k, v = _qkv(np.random.default_rng(10), S=1, T=64)
    lens = [10, 40] if per_row else 37
    jl = jnp.asarray(lens)
    tl = torch.as_tensor(lens) if per_row else lens
    common = dict(causal=True, window=window, softcap=softcap)
    theirs, mine = _both(q, k, v,
                         dict(q_offset=jl, kv_valid_len=jl + 1, **common),
                         dict(q_offset=tl, kv_valid_len=tl + 1, **common))
    np.testing.assert_allclose(mine, theirs, rtol=RTOL, atol=ATOL)


def test_window_and_softcap_change_the_output():
    """Neither argument is ignored: each moves the output far past the
    tolerance."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.default_rng(11)))
    base = chunked_attention(q, k, v, chunk=16)
    for kw in (dict(window=8), dict(softcap=2.0)):
        other = chunked_attention(q, k, v, chunk=16, **kw)
        assert float((other - base).abs().max()) > 1e-2, kw
