"""The port's bitonic network (raft_tpu_torch.matrix.bitonic) against the
JAX reference's: the same compare-exchange network, so keys AND payloads
agree bit for bit, ties included (a stable torch.sort would order equal
keys differently)."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from raft_tpu.matrix import bitonic as jax_bitonic
from raft_tpu_torch.matrix import bitonic
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


@pytest.mark.parametrize("L,descending", [
    (8, False), (64, True), (256, False)])
def test_sort_by_key_bitwise_on_tied_keys(L, descending):
    rng = np.random.default_rng(L + 7 * descending)
    # few distinct keys: most rows are full of ties
    keys = rng.integers(0, 5, (9, L)).astype(np.float32)
    keys[0, : L // 2] = np.inf                      # +inf padding
    ids = rng.integers(-1, 1000, (9, L)).astype(np.int32)
    flags = rng.random((9, L)) < 0.5
    jk, (ji, jf) = jax.jit(functools.partial(
        jax_bitonic.sort_by_key, descending=descending))(
        jnp.asarray(keys), jnp.asarray(ids), jnp.asarray(flags))
    tk, (ti, tf) = bitonic.sort_by_key(
        torch.from_numpy(keys), torch.from_numpy(ids),
        torch.from_numpy(flags), descending=descending)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    step = np.diff(np.minimum(tk.numpy(), 1e30), axis=1)
    assert np.all(step <= 0) if descending else np.all(step >= 0)


def test_sort_by_key_integer_keys_and_leading_dims():
    rng = np.random.default_rng(3)
    keys = rng.integers(-3, 3, (2, 3, 32)).astype(np.int32)
    pay = rng.standard_normal((2, 3, 32)).astype(np.float32)
    jk, (jp,) = jax.jit(jax_bitonic.sort_by_key)(jnp.asarray(keys),
                                                 jnp.asarray(pay))
    tk, (tp,) = bitonic.sort_by_key(torch.from_numpy(keys),
                                    torch.from_numpy(pay))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_non_pow2_raises():
    with pytest.raises(ValueError, match="power of two"):
        bitonic.sort_by_key(torch.zeros(3, 12))
