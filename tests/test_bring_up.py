"""The pieces that make the program run on a GPU, checked on the CPU:
the compile-cache rule, the feature budget, the pytree dataclasses that
replace Flax's, chip_smoke.py's refusal of other devices and choice of
phases, and the multihost launcher's cards per process."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fgnn_tpu.placement import (ENV_FEAT_BUDGET, HEADROOM_FRAC, feat_budget,
                                features_fit)
from fgnn_tpu.utils import compile_cache, pytree_dataclass, static_field

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_rule(monkeypatch, tmp_path, env_set):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv(compile_cache.ENV_CACHE_DIR, str(tmp_path))
    else:
        monkeypatch.delenv(compile_cache.ENV_CACHE_DIR, raising=False)
    try:
        used = compile_cache.use_compile_cache()
        after = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    if env_set:
        # JAX reads the variable itself; the helper sets nothing
        assert used == str(tmp_path)
        assert after == before
    else:
        assert used == after == os.path.join(REPO, ".jax_cache")


# ---------------------------------------------------------------------------
# feature budget
# ---------------------------------------------------------------------------

class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_feat_budget_from_device_limit(monkeypatch):
    monkeypatch.delenv(ENV_FEAT_BUDGET, raising=False)
    limit, graph = 60 << 30, 6 << 30
    budget = feat_budget(graph, _FakeDevice({"bytes_limit": limit}))
    assert budget == int(limit * (1 - HEADROOM_FRAC)) - graph
    assert features_fit(budget, budget)
    assert not features_fit(budget + 1, budget)
    # a graph larger than the budget leaves no room, never a negative one
    assert feat_budget(limit, _FakeDevice({"bytes_limit": limit})) == 0


def test_feat_budget_without_device_limit(monkeypatch):
    """A device that reports no limit (the CPU backend) keeps features on
    the device whatever their size."""
    monkeypatch.delenv(ENV_FEAT_BUDGET, raising=False)
    assert feat_budget(1 << 30, _FakeDevice(None)) is None
    assert feat_budget(1 << 30, _FakeDevice({})) is None
    assert features_fit(1 << 50, None)


def test_feat_budget_env_override(monkeypatch):
    monkeypatch.setenv(ENV_FEAT_BUDGET, "0")
    assert feat_budget(0, _FakeDevice({"bytes_limit": 80 << 30})) == 0
    assert not features_fit(1, 0)


# ---------------------------------------------------------------------------
# pytree dataclasses
# ---------------------------------------------------------------------------

@pytree_dataclass
class _Box:
    x: jnp.ndarray
    scale: int = static_field(default=1)
    extra: object = None


def test_pytree_dataclass_static_fields_survive_jit():
    box = _Box(jnp.arange(4, dtype=jnp.float32), scale=3)
    assert len(jax.tree.leaves(box)) == 1   # static field is no leaf

    traces = []

    @jax.jit
    def f(b):
        traces.append(type(b.scale))
        return b.replace(x=b.x * b.scale)

    out = f(box)
    assert traces == [int]                  # a Python int while tracing
    assert out.scale == 3
    np.testing.assert_array_equal(np.asarray(out.x), [0, 3, 6, 9])
    f(_Box(jnp.ones(4), scale=3))
    assert len(traces) == 1                 # same static value: no retrace
    f(_Box(jnp.ones(4), scale=2))
    assert len(traces) == 2                 # new static value: retrace


def test_pytree_dataclass_replace_and_frozen():
    box = _Box(jnp.zeros(2), scale=2)
    new = box.replace(scale=5)
    assert new.scale == 5 and box.scale == 2
    assert new.x is box.x
    with pytest.raises(dataclasses.FrozenInstanceError):
        box.scale = 7
    mapped = jax.tree.map(lambda a: a + 1, box)
    assert isinstance(mapped, _Box) and mapped.scale == 2
    np.testing.assert_array_equal(np.asarray(mapped.x), [1, 1])


# ---------------------------------------------------------------------------
# chip_smoke.py
# ---------------------------------------------------------------------------

def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _no_result(stdout: str) -> bool:
    return '"ok"' not in stdout


def test_chip_smoke_refuses_a_cpu_device():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert _no_result(r.stdout)
    assert "needs a GPU" in r.stdout + r.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert _no_result(r.stdout)


@pytest.mark.parametrize("four_cards", [False, True])
def test_chip_smoke_phase_selection(monkeypatch, capsys, four_cards):
    """--four-cards runs the device check and its own phase only; a plain
    run takes phases (a)-(e) in order."""
    import chip_smoke

    monkeypatch.setenv("XLA_FLAGS", "")
    calls = []
    devs = ["dev0", "dev1", "dev2", "dev3"]
    eng = types.SimpleNamespace(feat_dev="table")
    batch = types.SimpleNamespace(input_nodes="ids")
    fakes = {
        "check_device": lambda n: calls.append(("device", n)) or devs[:n],
        "four_cards": lambda d: calls.append(("four-cards", len(d))),
        "main_path": lambda: calls.append("main") or ("ds", eng),
        "correctness": lambda ds, e: calls.append("correct") or batch,
        "families": lambda: calls.append("families"),
        "gather_timing": lambda t, i: calls.append(("gather", t, i)),
    }
    for name, fn in fakes.items():
        monkeypatch.setattr(chip_smoke, name, fn)
    argv = ["--four-cards"] if four_cards else []
    assert chip_smoke.main(argv) == 0
    if four_cards:
        assert calls == [("device", 4), ("four-cards", 4)]
    else:
        assert calls == [("device", 1), "main", "correct", "families",
                         ("gather", "table", "ids")]
    # the deterministic flag is for the gate child only, never this process
    assert os.environ["XLA_FLAGS"] == ""
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["ok"] is True
    assert set(last["device"]) == {"platform", "kind", "count"}


# ---------------------------------------------------------------------------
# multihost: cards per process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,want", [("", None), ("0", [0]),
                                        ("1,3", [1, 3])])
def test_multihost_local_device_ids(monkeypatch, value, want):
    """Unset: the process drives all of its host's cards; otherwise the
    listed ones (one process per card)."""
    from fgnn_tpu.parallel.multihost import local_device_ids_from_env

    monkeypatch.setenv("FGNN_TPU_LOCAL_DEVICE_IDS", value)
    assert local_device_ids_from_env() == want
