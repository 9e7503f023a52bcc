"""The port's single-card front doors on the CPU: the serving CLI
(``repro_torch.launch.serve``) and the five examples
(``repro_torch.examples.*``), each run through its ``main`` at its
reference's smoke sizes.  The analytic figures the examples print are
held to the JAX package's functions in the same process: exactly for the
chosen schedules, the FlexTree cycles, the counts and the skip fractions;
energies within 1e-12 relative (both sides sum the same float64 terms).

Every entry point runs on CUDA unless ``--device cpu``: without a card
and without that flag, ``main`` raises.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import base as pt_base

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-12


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The examples' CPU work on one intra-op thread: the suite's workers
    share the machine's cores, and at a thread per core each the searches
    ran ten times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_example(name):
    """A module of the reference's ``examples/`` (those guarded by
    ``__main__``), loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"ref_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# launch/serve.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-vl-72b",
                                  "llama4-scout-17b-a16e"])
def test_serve_cli_serves_every_request_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "5", "--prompt-len", "6", "--max-new",
                      "5", "--slots", "2", "--max-seq", "32"])
    assert sorted(res) == [1, 2, 3, 4, 5]
    assert all(len(t) == 5 for t in res.values())
    vocab = pt_base.get_smoke_config(arch).vocab
    assert all(0 <= v < vocab for t in res.values() for v in t)
    out = capsys.readouterr().out
    assert "served 5 requests, 25 tokens" in out
    assert out.count("  req ") == 4


def test_serve_cli_engine_on_cpu_is_float32_and_plain():
    from repro_torch.launch import serve
    eng = serve.make_engine(serve.parse_args(
        ["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu"]))
    assert eng.params["embed"].dtype == torch.float32
    assert eng.exec_cfg is None and eng.device.type == "cpu"


ENTRY_POINTS = {
    "launch.serve": ["--arch", "stablelm-1.6b", "--smoke"],
    "launch.train": ["--arch", "stablelm-1.6b", "--smoke"],
    "examples.quickstart": [],
    "examples.schedule_explorer": ["--net", "yolov2"],
    "examples.serve_batched": [],
    "examples.sparse_serving": [],
    "examples.train_lm": [],
}


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal where no card is present")
@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_refuse_to_run_without_a_card(name):
    mod = importlib.import_module(f"repro_torch.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(ENTRY_POINTS[name])


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def test_quickstart_figures_equal_reference(capsys):
    import jax.numpy as jnp

    from repro.configs.base import SHAPES, get_config
    from repro.core import flextree as ref_ft
    from repro.core import sparsity as ref_sp
    from repro.core.descriptors import compile_network_schedule
    from repro.core.energy_model import DENSE, FLEXNN, ConvLayer
    from repro.core.scheduler import optimize_layer
    from repro_torch.examples import quickstart

    got = quickstart.main(["--device", "cpu"])
    assert "quickstart complete." in capsys.readouterr().out

    layer = ConvLayer("resnet50.conv2_1x1", ox=56, oy=56, oc=256, ic=64)
    flex = optimize_layer(layer, FLEXNN, DENSE)
    s = got["schedules"]
    assert s["schedule"] == flex.schedule.describe()
    assert s["energy"] == pytest.approx(flex.energy, rel=REL)
    assert s["cycles"] == pytest.approx(flex.cycles, rel=REL)
    for df, e in s["fixed"].items():
        assert e == pytest.approx(optimize_layer(
            layer, FLEXNN, DENSE, dataflow=df).energy, rel=REL)

    # the reference's step 2 on the same numpy draws
    rng = np.random.default_rng(0)
    x = ref_sp.prune_magnitude(rng.normal(size=(8, 16)).astype(np.float32),
                               0.6)
    a_bm, w_bm = rng.random(128) < 0.5, rng.random(128) < 0.4
    a = ref_sp.prune_magnitude(rng.normal(size=(256, 256)).astype(
        np.float32), 0.6, block=(64, 64))
    b = ref_sp.prune_magnitude(rng.normal(size=(256, 256)).astype(
        np.float32), 0.6, block=(64, 64))
    meta = ref_sp.build_block_sparse_meta(a, b, 64, 64, 64)
    t = got["two_sided"]
    assert t["nnz"] == int(np.count_nonzero(x))
    assert (t["if_nz"], t["fl_nz"]) == (int(a_bm.sum()), int(w_bm.sum()))
    assert t["pairs"] == int(ref_sp.csb_popcount(jnp.asarray(a_bm),
                                                 jnp.asarray(w_bm)))
    assert t["skip"] == pytest.approx(meta.skip_fraction, rel=REL)
    assert t["err"] < 1e-4

    for ic_p, (chain, tree, speedup) in got["flextree"].items():
        assert chain == ref_ft.neighbor_chain_cycles(256, ic_p)
        assert tree == ref_ft.flextree_cycles(256, ic_p)
        assert speedup == ref_ft.flextree_speedup_vs_chain(256, ic_p)

    ns = compile_network_schedule(get_config("yi-9b"), SHAPES["train_4k"],
                                  model_shards=16)
    for site, line in got["descriptors"].items():
        assert line == ns.sites[site].describe()

    losses = [r["loss"] for r in got["train"]]
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("net,sparse", [("yolov2", False),
                                        ("mobilenet_v2", True)])
def test_schedule_explorer_equals_reference(net, sparse, capsys,
                                            monkeypatch):
    """yolov2 (23 layers, the zoo's shortest) dense; mobilenet_v2 (the
    shortest with §V-C profiles) sparse on its first 8 layers on both
    sides, whose profiles seed from ``hash(network)``, so both sides run
    in this process."""
    from repro.configs.cnn_zoo import NETWORKS
    from repro.core.energy_model import DENSE, FLEXNN
    from repro.core.scheduler import optimize_layer
    from repro.core.sparsity_profiles import profiles_for
    from repro_torch.configs import cnn_zoo as pt_zoo
    from repro_torch.examples import schedule_explorer

    if sparse:
        for zoo in (NETWORKS, pt_zoo.NETWORKS):
            monkeypatch.setitem(zoo, net, lambda full=zoo[net]: full()[:8])
    argv = ["--net", net, "--device", "cpu"] + (["--sparse"] * sparse)
    got = schedule_explorer.main(argv)
    out = capsys.readouterr().out
    assert "No fixed dataflow is optimal everywhere" in out

    ref = ref_example("schedule_explorer")
    layers = NETWORKS[net]()
    stats = profiles_for(net, layers) if sparse else [DENSE] * len(layers)
    assert len(got["layers"]) == len(layers)
    wins = {}
    for row, layer, sp in zip(got["layers"], layers, stats):
        flex = optimize_layer(layer, FLEXNN, sp)
        fixed = {df: optimize_layer(layer, FLEXNN, sp, dataflow=df).energy
                 for df in ref.DATAFLOWS}
        best = min(fixed, key=fixed.get)
        wins[best] = wins.get(best, 0) + 1
        assert row["layer"] == layer.name
        assert row["schedule"] == flex.schedule.describe(), layer.name
        assert row["best_fixed"] == best, layer.name
        assert row["energy"] == pytest.approx(flex.energy, rel=REL)
        for df in ref.DATAFLOWS:
            assert row["fixed"][df] == pytest.approx(fixed[df], rel=REL)
    assert got["wins"] == wins


def test_serve_batched_runs_on_cpu(capsys):
    from repro_torch.examples import serve_batched
    got = serve_batched.main(["--device", "cpu"])
    assert len(got["async"]) == 8
    assert all(len(v) == 12 for v in got["async"].values())
    assert list(got["oracle"].values()) == list(got["async"].values())
    assert got["adaptive"] == list(got["oracle"].values())
    assert "streams unchanged" in capsys.readouterr().out


def test_sparse_serving_figures_equal_reference():
    import jax.numpy as jnp

    from repro.configs.base import get_smoke_config
    from repro.core import sparsity as ref_sp
    from repro_torch.examples import sparse_serving

    got = sparse_serving.main(["--device", "cpu"])
    # the reference's steps on the same numpy draws
    cfg = get_smoke_config("yi-9b")
    rng = np.random.default_rng(0)
    d, f = cfg.d_model, cfg.d_ff
    w_in = ref_sp.prune_magnitude(rng.normal(size=(d, f)).astype(np.float32)
                                  * 0.05, 0.6, block=(16, 16))
    x = rng.normal(size=(64, d)).astype(np.float32)
    x = np.where(x > 0.3, x, 0.0)
    meta = ref_sp.build_block_sparse_meta(
        x, w_in, 16, 16, 16, a_bitmap=ref_sp.block_bitmap(x, 16, 16),
        b_bitmap=ref_sp.block_bitmap(w_in, 16, 16))
    assert got["skip"] == pytest.approx(meta.skip_fraction, rel=REL)
    assert got["zvc_ratio"] == pytest.approx(
        ref_sp.zvc_compressed_bytes(w_in, 4) / w_in.nbytes, rel=REL)
    assert got["pe_speedup"] == pytest.approx(
        ref_sp.simulate_pe_cycles(256, 16, 64, 1.0)
        / ref_sp.simulate_pe_cycles(256, 16, 64, float((x != 0).mean())
                                    * float((w_in != 0).mean())), rel=1e-6)
    assert got["err"] == 0.0 and got["exact"] < 1e-4
    w_plan = ref_sp.prune_k_blocks(w_in, 16, 16, max_live=d // 16 // 2)
    pw = ref_sp.plan_weight(jnp.asarray(w_plan), site="mlp.in",
                            mode="two_sided", bm=16, bk=16, bn=16)
    assert (got["plan"]["max_nnz"], got["plan"]["tk"]) == (pw.max_nnz, pw.tk)
    moe = got["moe"]
    assert moe["leaves"] > 0 and len(moe["tokens"][0]) == 4
    assert {s for s in moe["experts"]} == {"moe.experts_in",
                                           "moe.experts_gate",
                                           "moe.experts_out"}
    assert all(e[0] == 8 and 1 <= e[1] <= e[2]
               for e in moe["experts"].values())


def test_train_lm_trains_a_tiny_config(tmp_path, capsys):
    """The seam: the reference's loop (n_micro 2, remat dots, checkpoints)
    on the stablelm smoke config; the default is the reference's ~100M
    model."""
    from repro_torch.examples import train_lm
    cfg = pt_base.get_smoke_config("stablelm-1.6b")
    log = train_lm.main(["--device", "cpu", "--steps", "12", "--batch", "4",
                         "--seq", "32", "--ckpt-dir", str(tmp_path)],
                        cfg=cfg)
    assert [r["step"] for r in log] == list(range(1, 13))
    assert "12 steps" in capsys.readouterr().out
    ref = ref_example("train_lm").lm_100m()
    ours = train_lm.lm_100m()
    assert ours.param_count() == ref.param_count()
    assert (ours.n_layers, ours.d_model, ours.vocab) == (8, 512, 100_352)
