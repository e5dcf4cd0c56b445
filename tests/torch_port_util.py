"""Helpers shared by the port's training tests: dropout seeds read off the
JAX key chain, a narrowed batch, and random encoder-layer trees."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.nn import transformer as jtr

from raindrop_tpu_torch.utils.dropout import DropoutSeeds, LayerSeeds


def seed32(key) -> int:
    """The uint32 seed the JAX `dropout` derives from a key."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint32).reshape(-1)
    with np.errstate(over="ignore"):
        return int((kd[-1] * np.uint32(0x85EBCA6B)) ^ kd[0])


def kernel_seed(key) -> int:
    """The int32 seed the JAX encoder hands its kernels from a key."""
    return int(jax.random.randint(key, (1,), 0, 2 ** 31 - 1, jnp.int32)[0])


def layer_seeds(keys) -> LayerSeeds:
    """LayerSeeds from a layer's 4 keys (attn/kernel, post-attn, ffn, post-ffn)."""
    return LayerSeeds(kernel_seed(keys[0]), *(seed32(k) for k in keys))


def pipeline_seeds(r_trans, nlayers: int, microbatches: int):
    """DropoutSeeds.pipeline from the encoder's key: microbatch m's stage s
    draws from fold_in(fold_in(r_trans, m), s) split in 4
    (raindrop_tpu/parallel/pipeline.py)."""
    return tuple(
        tuple(layer_seeds(jax.random.split(
            jax.random.fold_in(jax.random.fold_in(r_trans, m), s), 4))
            for s in range(nlayers))
        for m in range(microbatches))


def seeds_from_jax_key(rng, nlayers: int, rows: int = 0,
                       pipeline: int = 0) -> DropoutSeeds:
    """The seeds `raindrop_apply(train=True, rng=rng)` of the JAX package
    consumes, by the same splits. `rows` = the batch size also reads the
    per-sample seeds of the COO propagation branch (one key per sample,
    split off each propagation layer's key); the dense use_beta block's
    two seeds come from fold_in(r_prop1, 1) split in two; `pipeline` > 0
    reads the GPipe route's seeds of that many microbatches."""
    r_drop, r_prop1, r_prop2, r_trans = jax.random.split(rng, 4)
    keys = jax.random.split(r_trans, 4 * nlayers)

    def per_sample(key):
        return tuple(seed32(k) for k in jax.random.split(key, rows)) if rows else ()

    beta = tuple(seed32(k) for k in jax.random.split(jax.random.fold_in(r_prop1, 1)))
    return DropoutSeeds(
        seed32(r_drop), seed32(r_prop1), seed32(r_prop2),
        tuple(layer_seeds(keys[4 * i: 4 * i + 4]) for i in range(nlayers)),
        per_sample(r_prop1), per_sample(r_prop2), beta,
        pipeline_seeds(r_trans, nlayers, pipeline) if pipeline else ())


def random_layer(seed: int, d: int, ffn: int):
    """A JAX encoder-layer tree (numpy leaves) with every bias and LayerNorm
    parameter random, so each one's gradient is exercised."""
    p = jax.device_get(jtr._layer_init(jax.random.PRNGKey(seed), d, ffn))
    rng = np.random.default_rng(seed)

    def r(n, base=0.0):
        return (base + 0.1 * rng.normal(size=(n,))).astype(np.float32)

    p["in_proj_b"] = r(3 * d)
    p["out_proj"]["b"] = r(d)
    p["ln1"] = {"scale": r(d, 1.0), "bias": r(d)}
    p["ln2"] = {"scale": r(d, 1.0), "bias": r(d)}
    return p


def to_torch(tree, requires_grad=False):
    if isinstance(tree, dict):
        return {k: to_torch(v, requires_grad) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, np.float32))
    return t.requires_grad_() if requires_grad else t


def model_batch(cfg, B, seed=1, lengths=None):
    """Time-major src [T, B, 2F], static, times [T, B], lengths [B]."""
    rng = np.random.default_rng(seed)
    T, F = cfg.max_len, cfg.d_inp
    if lengths is None:
        lengths = np.array(([T, max(T - 7, 1), 0] * B)[:B], np.int32)
    live = np.arange(T)[:, None] < lengths[None, :]                # [T, B]
    mask = ((rng.uniform(size=(T, B, F)) > 0.5) & live[..., None]).astype(np.float32)
    src = np.concatenate([rng.normal(size=(T, B, F)).astype(np.float32) * mask,
                          mask], -1)
    times = (np.cumsum(rng.uniform(0.1, 1.0, size=(T, B)), 0) * live).astype(np.float32)
    static = (rng.normal(size=(B, cfg.d_static)).astype(np.float32)
              if cfg.static else None)
    return src, static, times, np.asarray(lengths, np.int32)


def baseline_seeds_from_jax_key(name, rng, cfg, hp=None):
    """The ModelSeeds a baseline family's JAX `apply(..., train=True,
    rng=rng)` consumes, by the same splits (baselines/adapters.py), or None
    for a family without dropout. MTGNN's graph noise is JAX's own
    uniform draw."""
    from raindrop_tpu_torch.utils.dropout import LayerSeeds, ModelSeeds

    n = cfg.nlayers

    def encoder(key):
        keys = jax.random.split(key, 4 * n)
        return tuple(layer_seeds(keys[4 * i: 4 * i + 4]) for i in range(n))

    if name == "transformer":
        r_drop, r_trans = jax.random.split(rng)
        return ModelSeeds(seed32(r_drop), encoder(r_trans))
    if name == "transformer_ctx":
        return ModelSeeds(0, encoder(rng))
    if name == "transformer_moe":
        r = jax.random.split(rng, 1 + 3 * n)
        return ModelSeeds(seed32(r[0]), tuple(
            LayerSeeds(kernel_seed(r[1 + 3 * i]), seed32(r[1 + 3 * i]),
                       seed32(r[2 + 3 * i]), 0, seed32(r[3 + 3 * i]))
            for i in range(n)))
    if name == "raindrop_v1":
        r_drop, _, r_trans = jax.random.split(rng, 3)
        return ModelSeeds(seed32(r_drop), encoder(r_trans))
    if name in ("grud", "grud_bce"):
        return ModelSeeds(steps=tuple(seed32(k) for k in
                                      jax.random.split(rng, cfg.max_len)))
    if name == "mtgnn":
        layers = (hp or {}).get("layers", 5)
        r_adj, r_drop = jax.random.split(rng)
        noise = np.asarray(jax.random.uniform(r_adj, (cfg.d_inp, cfg.d_inp)))
        return ModelSeeds(seed32(r_drop),
                          steps=tuple(seed32(jax.random.fold_in(r_drop, i))
                                      for i in range(layers)),
                          graph_noise=torch.from_numpy(noise.copy()))
    return None


def without_meta(tree, leaf=np.asarray):
    """A JAX baseline tree (nested dicts and lists) without its static
    `_meta` entries, each leaf through `leaf`: the port's tree."""
    if isinstance(tree, dict):
        return {k: without_meta(v, leaf) for k, v in tree.items() if k != "_meta"}
    if isinstance(tree, (list, tuple)):
        return [without_meta(v, leaf) for v in tree]
    return leaf(tree)



def jax_baseline_params(name, hp=None, seed=0, dataset="eICU", **cfg_kw):
    """A baseline family's parameters in the JAX package's tree (its
    `_meta` included), as numpy arrays: the port's init from `seed` laid
    on the tree of the JAX adapter's init (jax.eval_shape: traced, no
    program compiled), every leaf's path, shape and dtype checked against
    it."""
    from raindrop_tpu.baselines import adapters as jadapters
    from raindrop_tpu.config import dataset_config as jax_dataset_config

    from raindrop_tpu_torch.baselines import adapters
    from raindrop_tpu_torch.bridge import params_to_numpy
    from raindrop_tpu_torch.config import dataset_config
    from raindrop_tpu_torch.train.checkpoint import flatten_params

    jinit, _ = jadapters.make_baseline(
        name, jax_dataset_config(dataset, **cfg_kw), dict(hp or {}))
    port = adapters.make_baseline(name, dataset_config(dataset, **cfg_kw), hp,
                                  device="cpu").init_fn(seed)
    leaves = dict(flatten_params(params_to_numpy(port)))

    def leaf(path, want):
        a = leaves.pop("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                for k in path))
        assert a.shape == want.shape and a.dtype == want.dtype, (path, a.shape, want)
        return a

    tree = jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(jinit, jax.random.PRNGKey(0)))
    assert not leaves, sorted(leaves)
    return tree


# the reference's state-dict names of the port's trees: the inverse of
# migrate's importers
def linear_sd(sd, name, p):
    sd[name + ".weight"] = p["w"]
    if "b" in p:
        sd[name + ".bias"] = p["b"]


def raindrop_state_dict(params):
    """The reference Raindrop_v2 state dict (code/models_rd.py:208-276) of
    the port's parameter tree: the inverse of migrate.import_raindrop's
    names (chip_smoke.py keeps its own copy), the leaves as they are."""
    sd = {"R_u": params["R_u"]}
    linear_sd(sd, "encoder", params["encoder"])
    for layer in ("ob_propagation", "ob_propagation_layer2"):
        p = params[layer]
        for lin in ("lin_key", "lin_query", "lin_value", "lin_skip", "increase_dim"):
            linear_sd(sd, f"{layer}.{lin}", p[lin])
        for k in ("weight", "bias", "nodewise_weights", "map_weights"):
            sd[f"{layer}.{k}"] = p[k]
    for name, p in params["transformer_encoder"].items():
        pre = f"transformer_encoder.layers.{int(name[len('layer'):])}."
        sd[pre + "self_attn.in_proj_weight"] = p["in_proj_w"]
        sd[pre + "self_attn.in_proj_bias"] = p["in_proj_b"]
        linear_sd(sd, pre + "self_attn.out_proj", p["out_proj"])
        linear_sd(sd, pre + "linear1", p["lin1"])
        linear_sd(sd, pre + "linear2", p["lin2"])
        for i in (1, 2):
            sd[pre + f"norm{i}.weight"] = p[f"ln{i}"]["scale"]
            sd[pre + f"norm{i}.bias"] = p[f"ln{i}"]["bias"]
    linear_sd(sd, "mlp_static.0", params["mlp_static"]["lin0"])
    linear_sd(sd, "mlp_static.2", params["mlp_static"]["lin1"])
    if "emb" in params:
        linear_sd(sd, "emb", params["emb"])
    return sd


def mtand_state_dict(params):
    """The reference enc_mtan_classif state dict (code/baselines/mTAND/
    models.py:54-100) of the port's mTAND tree: the inverse of
    migrate.import_mtand's names; the query points are the constructor's
    linspace, not a state-dict entry."""
    sd = {}
    for ours, theirs in (("att_q", "att.linears.0"), ("att_k", "att.linears.1"),
                         ("att_out", "att.linears.2"), ("periodic", "periodic"),
                         ("linear", "linear")):
        linear_sd(sd, theirs, params[ours])
    for i, j in ((0, 0), (1, 2), (2, 4)):
        linear_sd(sd, f"classifier.{j}", params["classifier"][f"lin{i}"])
    for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
        sd[f"enc.{k.replace('w_', 'weight_').replace('b_', 'bias_')}_l0"] = params["gru"][k]
    return sd
