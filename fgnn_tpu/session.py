"""Reference-compatible session API.

Mirrors the reference's Python surface — ``samgraph.common.SamGraphBasics``
(ctypes wrapper, samgraph/common/__init__.py:343-500) and
``samgraph.torch`` (adapter.py) — so code written against the reference
maps 1:1:

    import fgnn_tpu.session as sam
    sam.config({...})
    sam.data_init()
    sam.sample_init(worker_id, ctx)
    sam.train_init(worker_id, ctx)
    sam.extract_start(count)
    sam.sample_once()
    key = sam.get_next_batch()
    blocks, feat, label = sam.get_blocks(key, num_layer)
    ...
    sam.report_step_average(epoch, step)
    sam.shutdown()

Here the multi-process choreography collapses into one process (mesh
roles replace fork-per-GPU), so sample_init/train_init configure roles on
the engine rather than spawning processes; get_blocks returns our padded
Block pytrees plus feats/labels ready for the models of fgnn_tpu.models.
"""
from __future__ import annotations

import queue
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import RunArch, RunConfig
from .data import load_dataset, make_synthetic_dataset
from .ops.extract import device_gather, host_gather, label_gather
from .utils import get_logger
from .utils.profiler import Profiler

log = get_logger(__name__)


class _Session:
    def __init__(self):
        self.cfg: Optional[RunConfig] = None
        self.ds = None
        self.engine = None
        self._batches: Dict[int, object] = {}
        self._pending: "queue.Queue" = queue.Queue()
        self._key_counter = 0
        self._epoch = 0
        self._step = 0

    # -- samgraph_config / data_init ------------------------------------
    def config(self, run_config: dict) -> None:
        known = {}
        extra = {}
        import dataclasses

        field_names = {f.name for f in dataclasses.fields(RunConfig)}
        for k, v in run_config.items():
            (known if k in field_names else extra)[k] = v
        self.cfg = RunConfig.from_dict(known)
        self._extra = extra

    def data_init(self) -> None:
        assert self.cfg is not None, "call config() first"
        from .utils import Timer

        t_load = Timer()
        if self.cfg.dataset == "synthetic":
            self.ds = make_synthetic_dataset(
                num_node=int(self._extra.get("synthetic_nodes", 100_000)),
                avg_degree=15, feat_dim=128, num_class=64,
                seed=self.cfg.seed,
            )
        else:
            self.ds = load_dataset(self.cfg.dataset,
                                   root=self.cfg.dataset_root)
        if (self.cfg.sample_type.value.startswith("weighted")
                and self.ds.prob_table is None):
            from .data.synthetic import build_alias_tables

            build_alias_tables(self.ds, seed=self.cfg.seed)
        # Real wall-clock for the load (+ alias-table build when the dataset
        # ships without one) — kLogInitL1LoadDataset analog (profiler.h:30-57,
        # engine.cc LoadGraphDataset timing).
        Profiler.get().log_init("init_load_dataset", t_load.passed())

    # -- sample_init / train_init (role setup) ---------------------------
    def sample_init(self, worker_id: int = 0, ctx: Optional[str] = None) -> None:
        self._ensure_engine()

    def train_init(self, worker_id: int = 0, ctx: Optional[str] = None) -> None:
        self._ensure_engine()

    def switch_init(self, worker_id: int = 0, ctx: Optional[str] = None,
                    cache_percentage: float = 0.0) -> None:
        """Register the balance switcher (samgraph_switch_init analog,
        operation.cc:357-362): must run before the engine is built; the
        epoch tail then trains on sampler+trainer chips."""
        assert self.engine is None, "switch_init must precede sample/train use"
        assert self.cfg is not None, "call config() first"
        self.cfg = self.cfg.replace(
            have_switcher=True, switch_cache_percentage=cache_percentage
        )

    def _ensure_engine(self):
        if self.engine is not None:
            return
        cfg, ds = self.cfg, self.ds
        assert ds is not None, "call data_init() first"
        if cfg.arch == RunArch.ARCH5:
            if cfg.have_switcher:
                from .parallel.switcher import SwitcherEngine

                self.engine = SwitcherEngine(cfg, ds)
            elif cfg.async_train:
                from .parallel.async_dp import AsyncFactoredEngine

                self.engine = AsyncFactoredEngine(cfg, ds)
            else:
                from .parallel.factored import FactoredEngine

                self.engine = FactoredEngine(cfg, ds)
        elif cfg.arch == RunArch.ARCH6:
            from .parallel.factored import SGNNEngine

            self.engine = SGNNEngine(cfg, ds)
        elif cfg.arch == RunArch.ARCH0:
            from .host_engine import HostSamplingEngine

            self.engine = HostSamplingEngine(cfg, ds)
        else:
            from .engine import OneChipEngine

            self.engine = OneChipEngine(cfg, ds)

    # -- stepwise sampling (arch1-4/7 style) -----------------------------
    def extract_start(self, count: int) -> None:
        """Pipeline mode: pre-sample `count` batches ahead
        (samgraph_extract_start analog). JAX async dispatch is the
        background thread."""
        for _ in range(count):
            self.sample_once()

    def sample_once(self) -> None:
        from .engine import OneChipEngine

        eng = self.engine
        assert isinstance(eng, OneChipEngine), (
            "stepwise API drives the single-chip engine (arch1-4); "
            "arch5/6 run whole epochs via run_epoch"
        )
        if not hasattr(self, "_batch_iter") or self._batch_iter is None:
            self._batch_iter = eng.shuffler.batches(self._epoch)
        try:
            seeds, n, step = next(self._batch_iter)
        except StopIteration:
            self._epoch += 1
            self._batch_iter = eng.shuffler.batches(self._epoch)
            seeds, n, step = next(self._batch_iter)
        key = jax.random.fold_in(
            jax.random.key(self.cfg.seed),
            self._epoch * eng.shuffler.num_step + step,
        )
        batch = eng.sample_jit(key, jnp.asarray(seeds), jnp.int32(n))
        batch_key = self._epoch * eng.shuffler.num_step + step
        self._pending.put((batch_key, batch))

    def get_next_batch(self) -> int:
        batch_key, batch = self._pending.get()
        self._batches[batch_key] = batch
        return batch_key

    def get_blocks(self, batch_key: int, num_layer: int):
        """get_dgl_blocks analog: (blocks, feat, label) for the model."""
        from .utils import Timer

        eng = self.engine
        prof = Profiler.get()
        t_conv = Timer()  # kL1Event_Convert span (graph->framework blocks)
        batch = self._batches[batch_key]
        assert len(batch.blocks) == num_layer
        if eng.feat_on_device:
            feats = device_gather(eng.feat_dev, batch.input_nodes)
        elif eng.cache is not None:
            index = eng.cache.get_miss_cache_index(batch.input_nodes)
            miss_t, _ = eng.cache.upload_miss(index)
            feats = eng.cache.combine(index, miss_t)
        else:
            feats = jnp.asarray(
                host_gather(self.ds.feat, np.asarray(batch.input_nodes),
                            mod=self.ds.feat_mod)
            )
        labels = label_gather(eng.label_dev, batch.output_nodes)
        ct = t_conv.passed()
        prof.log_step(batch_key, "L1_convert_time", ct)
        if prof.trace_enabled:
            prof.trace_event(batch_key, "kL1Event_Convert",
                             t_conv._start * 1e6, Timer.now_us())
        return batch.blocks, feats, labels

    def get_graph_num_src(self, batch_key: int, layer: int) -> int:
        return int(self._batches[batch_key].blocks[layer].num_src)

    def get_graph_num_dst(self, batch_key: int, layer: int) -> int:
        return int(self._batches[batch_key].blocks[layer].num_dst)

    # -- arch7-style accessors (sgnn_dgl apps): the framework samples,
    # the APP extracts features itself via load_subtensor
    # (torch/adapter.py:170-179 analog) --------------------------------
    def get_graph_input_nodes(self, batch_key: int):
        return self._batches[batch_key].input_nodes

    def get_graph_output_nodes(self, batch_key: int):
        return self._batches[batch_key].output_nodes

    @staticmethod
    def load_subtensor(feat, input_nodes):
        """App-side feature extraction (adapter.py:170-179): gather rows
        of `feat` (device array OR host/mmap ndarray) for the batch."""
        if isinstance(feat, np.ndarray):
            return jnp.asarray(host_gather(feat, np.asarray(input_nodes)))
        return device_gather(feat, input_nodes)

    def release_batch(self, batch_key: int) -> None:
        self._batches.pop(batch_key, None)

    # -- meta getters (samgraph_num_class etc.) --------------------------
    def num_class(self) -> int:
        return self.ds.num_class

    def feat_dim(self) -> int:
        return self.ds.feat_dim

    def num_epoch(self) -> int:
        return self.cfg.num_epoch

    def steps_per_epoch(self) -> int:
        return self.engine.shuffler.num_step

    # -- profiler passthrough --------------------------------------------
    def report_step_average(self, epoch: int, step: int) -> str:
        return Profiler.get().report_step_average(epoch, step)

    def report_init(self) -> str:
        """samgraph_report_init analog."""
        return Profiler.get().report_init()

    def get_log_epoch_value(self, epoch: int, item: str) -> float:
        return Profiler.get().get_epoch_value(epoch, item)

    def get_log_step_value(self, key: int, item: str) -> float:
        return Profiler.get().get_step_value(key, item)

    def dump_trace(self, path: str = "trace.json") -> None:
        Profiler.get().dump_trace(path)

    def shutdown(self) -> None:
        self.engine = None
        self._batches.clear()
        self._batch_iter = None


_session = _Session()

# module-level API (samgraph.torch style)
config = _session.config
data_init = _session.data_init
sample_init = _session.sample_init
train_init = _session.train_init
switch_init = _session.switch_init
extract_start = _session.extract_start
sample_once = _session.sample_once
get_next_batch = _session.get_next_batch
get_blocks = _session.get_blocks
get_dgl_blocks = _session.get_blocks         # migration alias (adapter.py name)
get_dgl_blocks_with_weights = _session.get_blocks  # weights ride on Block.weights
get_graph_num_src = _session.get_graph_num_src
get_graph_num_dst = _session.get_graph_num_dst
get_graph_input_nodes = _session.get_graph_input_nodes
get_graph_output_nodes = _session.get_graph_output_nodes
load_subtensor = _session.load_subtensor
release_batch = _session.release_batch
num_class = _session.num_class
feat_dim = _session.feat_dim
num_epoch = _session.num_epoch
steps_per_epoch = _session.steps_per_epoch
report_step_average = _session.report_step_average
report_init = _session.report_init
get_log_epoch_value = _session.get_log_epoch_value
get_log_step_value = _session.get_log_step_value
dump_trace = _session.dump_trace
shutdown = _session.shutdown


def _reset_for_tests():
    global _session
    _session.shutdown()
    _session.__init__()
