"""Checkpoint/resume — save per epoch, restore on engine rebuild."""
import numpy as np

from fgnn_tpu.config import RunConfig, SampleType
from fgnn_tpu.data import make_synthetic_dataset
from fgnn_tpu.engine import OneChipEngine


def _cfg(tmp_path):
    return RunConfig(model="graphsage", fanout=(4, 4), batch_size=128,
                     num_hidden=32, sample_type=SampleType.KHOP0,
                     dropout=0.0, lr=0.01,
                     ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=1)


def test_checkpoint_roundtrip(tmp_path):
    ds = make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=16,
                                num_class=4, seed=3)
    cfg = _cfg(tmp_path)
    eng = OneChipEngine(cfg, ds)
    assert eng.ckpt is not None
    assert eng.start_epoch == 0
    eng.run_epoch(0)
    eng.run_epoch(1)
    params_after = np.asarray(
        np.concatenate([np.ravel(x) for x in
                        __import__("jax").tree.leaves(eng.state.params)])
    )

    # rebuild: restores epoch 1 state, resumes at epoch 2
    eng2 = OneChipEngine(cfg, ds)
    assert eng2.start_epoch == 2
    params_restored = np.asarray(
        np.concatenate([np.ravel(x) for x in
                        __import__("jax").tree.leaves(eng2.state.params)])
    )
    np.testing.assert_allclose(params_restored, params_after, rtol=1e-6)


def test_factored_checkpoint(tmp_path):
    from fgnn_tpu.parallel.factored import FactoredEngine

    ds = make_synthetic_dataset(num_node=2000, avg_degree=8, feat_dim=16,
                                num_class=4, seed=3)
    cfg = _cfg(tmp_path).replace(num_sample_worker=2, num_train_worker=2)
    eng = FactoredEngine(cfg, ds)
    eng.run_epoch(0)
    eng2 = FactoredEngine(cfg, ds)
    assert eng2.start_epoch == 1
    r = eng2.run_epoch(eng2.start_epoch)
    assert np.isfinite(r["loss"])
