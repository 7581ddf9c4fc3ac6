"""The port's LPIPS (gauspcc_tpu_torch/utils/lpips.py) against the JAX
package's (gauspcc_tpu/utils/lpips.py) on the CPU, on one weights file and
the same seeded images.

Tolerances, each with its reason:
- `random_weights`: bit for bit (the same numpy draws in the same order);
- the distance: rel 1e-5 (float32 convolutions summed in another order by
  XLA and oneDNN, through 13 layers);
- equal images: abs 1e-6, and symmetry rel 1e-5, as tests/test_lpips.py
  holds the JAX package's.
"""

import numpy as np
import pytest
import torch

from gauspcc_tpu.utils import lpips as jlpips
from gauspcc_tpu_torch.utils import lpips

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small convolutions on many threads oversubscribe the cores that
    parallel test workers share; on one thread they run as fast."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("lpips") / "w.npz"
    np.savez(path, **lpips.random_weights(0))
    return str(path)


def _images(shape, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.random(shape).astype(np.float32),
            rng.random(shape).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1234])
def test_random_weights_equal_jax(seed):
    got, want = lpips.random_weights(seed), jlpips.random_weights(seed)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("shape", [(3, 32, 32), (3, 48, 40)])
def test_lpips_matches_jax(weights_file, shape):
    """[3, 48, 40] pools 24x20 -> 12x10 -> 6x5 -> 3x2: the odd sizes floor."""
    a, b = _images(shape)
    want = float(jlpips.load_default_lpips(weights_file)(a, b))
    fn = lpips.load_default_lpips(weights_file, device="cpu")
    assert fn.variant == "vgg16_pretrained"
    got = fn(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(want, rel=RTOL)


def test_zero_on_equal_and_symmetric(weights_file):
    fn = lpips.load_default_lpips(weights_file, device="cpu")
    a, b = (torch.from_numpy(x) for x in _images((3, 32, 32)))
    assert float(fn(a, a)) == pytest.approx(0.0, abs=1e-6)
    d_ab, d_ba = float(fn(a, b)), float(fn(b, a))
    assert d_ab > 0
    assert d_ab == pytest.approx(d_ba, rel=RTOL)


def test_weights_resolution_and_variants(weights_file, tmp_path, monkeypatch):
    """The argument, then $GAUSPCC_LPIPS_WEIGHTS, then lpips_vgg.npz beside
    the port's module (absent here: the seeded surrogate, random_weights(1234),
    as the JAX package's falls back to)."""
    assert lpips.weights_path() == lpips._DEFAULT_PATH
    assert lpips._DEFAULT_PATH.endswith("gauspcc_tpu_torch/utils/lpips_vgg.npz")
    a, b = _images((3, 32, 32), seed=2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    monkeypatch.setenv("GAUSPCC_LPIPS_WEIGHTS", weights_file)
    assert lpips.weights_path() == weights_file
    from_env = lpips.load_default_lpips(device="cpu")
    assert from_env.variant == "vgg16_pretrained"
    assert float(from_env(ta, tb)) == pytest.approx(
        float(jlpips.load_default_lpips()(a, b)), rel=RTOL)
    missing = str(tmp_path / "none.npz")
    monkeypatch.setenv("GAUSPCC_LPIPS_WEIGHTS", missing)
    surrogate = lpips.load_default_lpips(device="cpu")
    jsurrogate = jlpips.load_default_lpips()
    assert surrogate.variant == jsurrogate.variant == "vgg_random_v1"
    assert float(surrogate(ta, tb)) == pytest.approx(float(jsurrogate(a, b)),
                                                     rel=RTOL)
    # the argument wins over the variable
    assert lpips.load_default_lpips(weights_file, device="cpu").variant == \
        "vgg16_pretrained"


def test_no_surrogate_raises(tmp_path):
    missing = str(tmp_path / "none.npz")
    with pytest.raises(FileNotFoundError):
        lpips.load_default_lpips(missing, allow_surrogate=False, device="cpu")
    with pytest.raises(FileNotFoundError):
        jlpips.load_default_lpips(missing, allow_surrogate=False)


def test_defaults_to_the_card(weights_file):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA"):
        lpips.load_default_lpips(weights_file)
