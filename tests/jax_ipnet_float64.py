"""How far IP-Net's train-mode logits lie from a float64 evaluation, in the
JAX package and in the port, on the first batch of
tests/test_torch_adapters.py's three steps: the measurement behind that
test's IP-Net bounds (LOGIT_ATOL, GRAD_RES).

    JAX_PLATFORMS=cpu python tests/jax_ipnet_float64.py

Each package runs in f32 in one process and in float64 in another (JAX's
x64 mode is set once per process); the script starts the float64 process
itself and prints, for parameter seeds 0 and 3, the largest distance of
each package's f32 logits from its own float64 logits, and of the two
float64 results from each other.
"""

import os
import subprocess
import sys

import numpy as np

X64 = os.environ.get("IPNET_X64") == "1"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402

jax.config.update("jax_enable_x64", X64)

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from raindrop_tpu.baselines import adapters as jadapters  # noqa: E402
from raindrop_tpu.config import dataset_config as jax_dataset_config  # noqa: E402

from raindrop_tpu_torch.baselines import adapters  # noqa: E402
from raindrop_tpu_torch.config import dataset_config  # noqa: E402

from test_torch_adapters import B, KW, port_params  # noqa: E402
from test_torch_trainer import _batch_np, _split  # noqa: E402
from torch_port_util import baseline_seeds_from_jax_key, jax_baseline_params  # noqa: E402

SEEDS = (0, 3)


def logits(seed, host, dtype):
    cfg = dataset_config("eICU", dropout=0.2, **KW)
    _, japply = jadapters.make_baseline(
        "ipnet", jax_dataset_config("eICU", dropout=0.2, **KW), {})
    port = adapters.make_baseline("ipnet", cfg, None, device="cpu")
    idx = np.random.default_rng(5).permutation(24)[:B]
    b = _batch_np(_split(cfg, 24), idx)
    key = jax.random.PRNGKey(100)
    src = b["P"].transpose(1, 0, 2).astype(dtype)
    times = b["time"].T.astype(dtype)
    static = None if b.get("static") is None else b["static"].astype(dtype)
    lengths = (times > 0).sum(0)
    jp = jax.tree_util.tree_map(
        lambda x: x.astype(dtype) if np.issubdtype(x.dtype, np.floating) else x, host)
    jl, _ = jax.jit(lambda p: japply(
        p, jnp.asarray(src), None if static is None else jnp.asarray(static),
        jnp.asarray(times), jnp.asarray(lengths), True, key))(jp)
    tp = jax.tree_util.tree_map(lambda t: t.to(torch.from_numpy(src).dtype),
                                port_params("ipnet", cfg, host))
    with torch.no_grad():
        pl, _ = port.apply_fn(
            tp, torch.from_numpy(src), None if static is None else torch.from_numpy(static),
            torch.from_numpy(times), torch.from_numpy(lengths).long(), True,
            baseline_seeds_from_jax_key("ipnet", key, cfg))
    return np.asarray(jl, np.float64), pl.numpy().astype(np.float64)


def main():
    if X64:
        hosts = {s: dict(np.load(sys.argv[1] + f"_{s}.npz", allow_pickle=True))
                 for s in SEEDS}
        for s in SEEDS:
            j64, p64 = logits(s, hosts[s]["host"].item(), np.float64)
            np.savez(sys.argv[1] + f"_{s}_out.npz", j64=j64, p64=p64)
        return
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        stem = os.path.join(tmp, "ipnet")
        hosts = {s: jax_baseline_params("ipnet", seed=s, **KW) for s in SEEDS}
        for s in SEEDS:
            np.savez(stem + f"_{s}.npz", host=np.array(hosts[s], dtype=object))
        subprocess.run([sys.executable, __file__, stem], check=True,
                       env={**os.environ, "IPNET_X64": "1"})
        for s in SEEDS:
            j32, p32 = logits(s, hosts[s], np.float32)
            out = np.load(stem + f"_{s}_out.npz")
            print(f"seed {s}: JAX f32 from JAX float64 {np.abs(j32 - out['j64']).max():.3e}, "
                  f"port f32 from port float64 {np.abs(p32 - out['p64']).max():.3e}, "
                  f"the two float64 results {np.abs(out['j64'] - out['p64']).max():.3e}")


if __name__ == "__main__":
    main()
