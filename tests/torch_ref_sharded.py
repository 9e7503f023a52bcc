"""The reference side of ``test_torch_dist_families.py``: the JAX package's
sharded functions on 4 forced host devices, run in a subprocess.

The test process has already brought JAX up on one device, so this
module runs as its own program (``start`` / ``finish``) with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
``JAX_PLATFORMS=cpu``.  Its mesh is
``jax.sharding.Mesh(np.array(jax.devices()).reshape(shape),
("data", "model"))``, whose axes are ``Auto``: under it the package's own
code runs unchanged (``jax.make_mesh`` would give ``Explicit`` axes,
which its ``shard_map`` and sharding constraints do not take).  Nothing
of the package is edited or patched.

Inputs and outputs are pickled dicts of numpy arrays:

- ``moe``: ``apply_moe`` under ``use_rules(make_rules(mesh))`` (the
  expert-parallel ``_apply_moe_ep`` where ``_ep_applicable`` holds, else
  the local path under GSPMD) — y and the gradients of every leaf and of
  x against the cotangent ``gy``; with ``local``, also the unsharded
  ``apply_moe`` (no rules) on the same inputs;
- ``steps``: ``build_train_step(mesh, rules)`` from the given parameters
  over the given batches — loss, grad norm, parameters and moments after
  each step.
"""
import os
import pickle
import subprocess
import sys

FLAGS = "--xla_force_host_platform_device_count=4"


def start(workdir: str, inputs) -> subprocess.Popen:
    """Write ``inputs`` and start this module on them (not waited for)."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    path = os.path.join(workdir, "ref_in.pkl")
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    env = {**os.environ, "XLA_FLAGS": FLAGS, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    log = open(os.path.join(workdir, "ref.log"), "w")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), path,
         os.path.join(workdir, "ref_out.pkl")],
        env=env, stdout=log, stderr=subprocess.STDOUT)


def finish(proc: subprocess.Popen, workdir: str, timeout: float = 170.0):
    """Wait for the subprocess and read its results (its log on failure)."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    if rc != 0:
        with open(os.path.join(workdir, "ref.log")) as f:
            raise RuntimeError(f"reference subprocess: {rc}\n"
                               f"{f.read()[-4000:]}")
    with open(os.path.join(workdir, "ref_out.pkl"), "rb") as f:
        return pickle.load(f)


def _mesh(shape):
    import jax
    import numpy as np
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))


def _np(tree):
    import jax
    import numpy as np
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _moe(case):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_smoke_config
    from repro.models import moe
    from repro.sharding.partition import make_rules, use_rules

    cfg = get_smoke_config(case["arch"])
    mesh = _mesh(case["mesh"])
    rules = make_rules(mesh, kind="train", n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads)
    p = jax.tree.map(jnp.asarray, case["params"])
    x, gy = jnp.asarray(case["x"]), jnp.asarray(case["gy"])

    def loss(p, x, sharded):
        if sharded:
            with use_rules(rules):
                y = moe.apply_moe(p, cfg, x)
        else:
            y = moe.apply_moe(p, cfg, x)
        return jnp.sum(y * gy), y

    out = {}
    for sharded in (True, False) if case.get("local") else (True,):
        with use_rules(rules):
            ep = moe._ep_applicable(cfg, x, rules)
        fn = jax.jit(jax.value_and_grad(lambda p, x: loss(p, x, sharded),
                                        argnums=(0, 1), has_aux=True))
        (_, y), (gp, gx) = fn(p, x)
        out["sharded" if sharded else "local"] = _np(
            {"y": y, "gx": gx, "gp": gp, "ep": ep})
    return out


def _steps(case):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ShapeConfig, get_smoke_config
    from repro.sharding.partition import make_rules
    from repro.train import optimizer as opt
    from repro.train.train_step import build_train_step

    cfg = get_smoke_config(case["arch"])
    mesh = _mesh(case["mesh"])
    rules = make_rules(mesh, kind="train", n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads)
    step = build_train_step(cfg, ShapeConfig(**case["shape"]),
                            opt.AdamWConfig(**case["opt"]), mesh, rules,
                            donate=False)
    p = jax.tree.map(jnp.asarray, case["params"])
    st = opt.init_opt_state(p)
    rec = []
    for b in case["batches"]:
        p, st, m = step(p, st, {k: jnp.asarray(v) for k, v in b.items()})
        rec.append(_np({"loss": m["loss"], "grad_norm": m["grad_norm"],
                        "params": p, "mu": st.mu, "nu": st.nu}))
    return rec


def main(inp_path: str, out_path: str) -> None:
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    out = {"moe": {k: _moe(c) for k, c in inp.get("moe", {}).items()},
           "steps": {k: _steps(c) for k, c in inp.get("steps", {}).items()}}
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".tmp", out_path)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
