"""Figure 16a analog: test accuracy vs wall-clock training time, run to
an accuracy PLATEAU.

Reference: exp/fig16a — accuracy-over-time curves proving FGNN's speedup
translates to faster convergence (parse_acc.py on timestamped accuracy
lines, reference trains papers100M to 56% and compares time-to-accuracy).
We emit the same curve — (elapsed_s, epoch, test_acc) per evaluation —
for arch1 (one chip), arch5 (factored), arch6 (SGNN) and the async arch5
variant, training until the accuracy stops improving (plateau), not a
fixed 3-epoch fragment.

The check the artifact carries: all four training modes reach the SAME
plateau (within --band), i.e. factoring / space-sharing / async updates
change wall-clock, not the accuracy frontier.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

HERE = os.path.dirname(os.path.abspath(__file__))


def build_engine(arch: str, ds, num_epoch: int):
    from fgnn_tpu.config import RunArch, RunConfig, SampleType

    base = dict(
        model="graphsage", fanout=(10, 10), batch_size=1000,
        sample_type=SampleType.KHOP0, dropout=0.5, lr=0.003,
        num_epoch=num_epoch,
    )
    if arch == "arch1":
        cfg = RunConfig(arch=RunArch.ARCH1, **base)
        from fgnn_tpu.engine import OneChipEngine

        return cfg, OneChipEngine(cfg, ds)
    if arch in ("arch5", "arch5_async"):
        cfg = RunConfig(
            arch=RunArch.ARCH5, num_sample_worker=2, num_train_worker=6,
            async_train=(arch == "arch5_async"), **base,
        )
        if arch == "arch5_async":
            from fgnn_tpu.parallel.async_dp import AsyncFactoredEngine

            return cfg, AsyncFactoredEngine(cfg, ds)
        from fgnn_tpu.parallel.factored import FactoredEngine

        return cfg, FactoredEngine(cfg, ds)
    if arch == "arch6":
        cfg = RunConfig(arch=RunArch.ARCH6, num_train_worker=8, **base)
        from fgnn_tpu.parallel.factored import SGNNEngine

        return cfg, SGNNEngine(cfg, ds)
    raise ValueError(arch)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--synthetic-nodes", type=int, default=100_000)
    p.add_argument("--max-epoch", type=int, default=40)
    p.add_argument("--patience", type=int, default=5,
                   help="stop when best acc hasn't improved by --tol in "
                        "this many consecutive evals")
    p.add_argument("--tol", type=float, default=0.003)
    p.add_argument("--band", type=float, default=0.05,
                   help="plateau-agreement band across archs")
    p.add_argument("--archs", nargs="+",
                   default=["arch1", "arch5", "arch6", "arch5_async"])
    p.add_argument("--cpu-mesh", action="store_true")
    args = p.parse_args()

    from fgnn_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()

    if args.cpu_mesh:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_cpu_collective_call_terminate_timeout_seconds=600"
            " --xla_force_host_platform_device_count=8"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")

    from fgnn_tpu.data import make_synthetic_dataset

    ds = make_synthetic_dataset(
        num_node=args.synthetic_nodes, avg_degree=15, feat_dim=64,
        num_class=32, seed=0,
    )

    curves, plateaus = {}, {}
    for arch in args.archs:
        cfg, eng = build_engine(arch, ds, args.max_epoch)
        curve = []
        best, best_epoch, stall = 0.0, -1, 0
        t0 = time.time()
        for e in range(args.max_epoch):
            eng.run_epoch(e)
            acc = eng.evaluate()
            elapsed = time.time() - t0
            curve.append({"time_s": elapsed, "epoch": e, "test_acc": acc})
            print(f"test_result:acc_curve:{arch}:{elapsed:.2f}={acc:.4f}",
                  flush=True)
            if acc > best + args.tol:
                best, best_epoch, stall = acc, e, 0
            else:
                stall += 1
            if stall >= args.patience:
                break
        curves[arch] = curve
        plateaus[arch] = {
            "plateau_acc": best,
            "plateau_epoch": best_epoch,
            "time_to_plateau_s": curve[best_epoch]["time_s"],
            "epochs_run": len(curve),
            "flattened": stall >= args.patience,
        }
        print(f"test_result:plateau:{arch}:acc={best:.4f} "
              f"epoch={best_epoch} t={curve[best_epoch]['time_s']:.1f}s "
              f"flattened={plateaus[arch]['flattened']}", flush=True)

    accs = [v["plateau_acc"] for v in plateaus.values()]
    agree = (max(accs) - min(accs)) <= args.band if len(accs) > 1 else True
    print(f"test_result:plateau_agreement:spread={max(accs)-min(accs):.4f} "
          f"band={args.band} agree={agree}", flush=True)

    with open(os.path.join(HERE, "fig16a.json"), "w") as f:
        json.dump({"curves": curves, "plateaus": plateaus,
                   "plateau_agreement": agree}, f, indent=2)
    with open(os.path.join(HERE, "fig16a.dat"), "w") as f:
        f.write(f"{'arch':<14}{'plateau_acc':>12}{'plateau_epoch':>14}"
                f"{'time_to_plateau_s':>19}{'epochs_run':>11}"
                f"{'flattened':>10}\n")
        for a, v in plateaus.items():
            f.write(f"{a:<14}{v['plateau_acc']:>12.4f}"
                    f"{v['plateau_epoch']:>14d}"
                    f"{v['time_to_plateau_s']:>19.1f}"
                    f"{v['epochs_run']:>11d}"
                    f"{str(v['flattened']):>10}\n")
    print(f"[exp] wrote fig16a.json + fig16a.dat (agreement={agree})")


if __name__ == "__main__":
    main()
