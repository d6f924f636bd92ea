"""The port's norms (``repro_torch.nn.layers.apply_norm``): the row mean is
one fixed tree of adds, so a token's norm does not depend on how many rows
share its batch, and the norm agrees with the reference's.

Tolerance against the reference: the two sum a row in different orders,
which moves the f32 mean by a few ulps; outputs get rtol 1e-6 (f32) and one
bf16 ulp at |y| ~ 1 (2^-7, bf16 inputs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.nn.layers import apply_norm as japply_norm  # noqa: E402
from repro_torch.nn.layers import apply_norm, row_mean  # noqa: E402

WIDTHS = (1, 3, 64, 576, 2048, 7168)


def _fold_mean(x: np.ndarray) -> np.ndarray:
    """The tree ``row_mean`` promises, in numpy f32: pad to a power of two
    with zeros, add the halves until one column is left, divide by n."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    s = np.concatenate([x, np.zeros(x.shape[:-1] + (width - n,), x.dtype)],
                       axis=-1)
    while s.shape[-1] > 1:
        half = s.shape[-1] // 2
        s = s[..., :half] + s[..., half:]
    return s / np.float32(n)


@pytest.mark.parametrize("width", WIDTHS)
def test_row_mean_is_one_fixed_tree(width):
    rng = np.random.default_rng(width)
    x = (rng.standard_normal((3, 5, width)) *
         np.exp2(rng.integers(-20, 20, (3, 5, 1)))).astype(np.float32)
    got = row_mean(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 5, 1)
    np.testing.assert_array_equal(got, _fold_mean(x))
    np.testing.assert_allclose(got[..., 0], x.astype(np.float64).mean(-1),
                               rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("rows", [1, 4, 8, 512])
def test_norm_of_a_row_does_not_depend_on_its_batch(rows):
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.standard_normal((1024, 2048)).astype(
        np.float32)).bfloat16()
    p = {"scale": torch.from_numpy(
        rng.uniform(0.5, 1.5, 2048).astype(np.float32))}
    full = apply_norm(p, x)
    assert torch.equal(apply_norm(p, x[:rows]), full[:rows])
    assert torch.equal(apply_norm(p, x[:rows].reshape(rows, 1, 2048)),
                       full[:rows].reshape(rows, 1, 2048))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_matches_reference(kind, dtype):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 6, 96)) * 3 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 96).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tp = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(japply_norm(jp, jx, kind).astype(jnp.float32))
    got = apply_norm(tp, tx, kind).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=2.0 ** -7)
