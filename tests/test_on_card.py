"""Checks that mean something only on a GPU; the `gpu` fixture skips them
elsewhere. On a machine with a card: ``pytest -m gpu tests/``. The same
checks run at the flagship width in chip_smoke.py phase (c)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _engine():
    from fgnn_tpu.config import RunConfig, SampleType
    from fgnn_tpu.data import make_synthetic_dataset
    from fgnn_tpu.engine import OneChipEngine

    ds = make_synthetic_dataset(num_node=20_000, avg_degree=15, feat_dim=128,
                                num_class=172, train_frac=0.2, seed=5)
    cfg = RunConfig(model="graphsage", fanout=(25, 10), batch_size=1024,
                    num_hidden=256, sample_type=SampleType.KHOP2)
    return ds, OneChipEngine(cfg, ds)


def test_sampler_and_model_on_card(gpu):
    """Sampled edges are CSR edges; the bf16 forward tracks the float32
    forward at matmul precision "highest", which matches the NumPy
    goldens."""
    import chip_smoke

    ds, eng = _engine()
    chip_smoke.correctness(ds, eng)


def test_device_gather_exact_on_card(gpu):
    from fgnn_tpu.ops.extract import device_gather

    rng = np.random.default_rng(0)
    table = rng.standard_normal((5000, 128)).astype(np.float32)
    ids = rng.integers(-1, 5000, 20_000).astype(np.int32)
    out = np.asarray(jax.jit(device_gather)(jnp.asarray(table),
                                            jnp.asarray(ids)))
    want = np.where((ids >= 0)[:, None], table[np.maximum(ids, 0)], 0.0)
    np.testing.assert_array_equal(out, want)
