"""Reference checkpoint import: torch artifacts trained by the reference
into the port's parameter trees (the port of raindrop_tpu/migrate.py).

The reference ships trained torch artifacts and loads them for evaluation:
`code/baselines/saved/grud_model_best.pt` (a full-module pickle,
`GRU-D_baseline.py:233,421`), `code/baselines/mTAND/best_model_val_aupr.pt`
(`mTAND_baseline.py:169-176`), `code/baselines/saved/best_model.pt` (an
unpublished `Transformer_P12` driver), raw parameter dicts like
`grud_mean_grud_para.pt`, and a user's own reference-trained Raindrop
checkpoints. This module maps them onto the port's trees:

    python -m raindrop_tpu_torch.migrate --model raindrop --torch model.pt --out model
    python -m raindrop_tpu_torch.serve --dataset P12 --checkpoint model

The output `<out>.npz` is a `train/checkpoint.save_checkpoint` file of the
parameters alone: `load_checkpoint(out, template)` reads it into
`raindrop_init(seed, cfg, device)`'s tree (the server's `--checkpoint`,
the `Trainer`'s `params=`), or into a baseline's (`make_baseline(...)
.init_fn(seed)`), as any checkpoint of the port.

  * The port's linear weights are stored in torch's layout `[out, in]`
    (nn/init.torch_linear_params), so every import is a rename and a cast,
    no transpose: the mapping can be checked by eye. The trees are numpy
    arrays, the leaves the JAX package's `import_params` gives bit for bit.
  * Only tensors are loaded by default: `torch.load(weights_only=True)`
    reads state dicts and `{'rec_state_dict': ...}` wrappers and refuses a
    pickled object. A full-module pickle (`torch.save(model)`) loads with
    `allow_full_pickle=True` (`--allow-full-pickle`) alone. Unpickling it
    RUNS CODE named in the file: open only files you trust. It then
    deserializes without the saved class's code: torch's pickle restores
    `__dict__` directly (`__init__` never runs), so a stub class injected
    under the saved module name (e.g. the unpublished
    `models.Transformer_P12`) yields the whole parameter tree and its
    submodules, and tensor attributes kept outside `state_dict()`
    (`GRUD.x_mean`) are collected too.
"""

from __future__ import annotations

import contextlib
import pickle
import sys
import types
from typing import Dict, Optional

import numpy as np

# names of modules the reference's full-module pickles resolve classes from
_PICKLE_MODULES = ("models",)


@contextlib.contextmanager
def _stub_pickle_modules(names=_PICKLE_MODULES):
    """Temporarily register stub modules whose attribute lookups mint bare
    `torch.nn.Module` subclasses, so `torch.load` of a full-module pickle
    works without the (possibly unpublished) class definitions. Restores
    `sys.modules` afterwards."""
    import torch.nn as nn

    saved = {}
    for name in names:
        saved[name] = sys.modules.get(name)
        mod = types.ModuleType(name)

        def _getattr(cls_name, _mod=mod):
            cls = type(cls_name, (nn.Module,), {"__module__": _mod.__name__})
            setattr(_mod, cls_name, cls)
            return cls

        mod.__getattr__ = _getattr
        sys.modules[name] = mod
    try:
        yield
    finally:
        for name, orig in saved.items():
            if orig is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = orig


def _to_numpy(t) -> np.ndarray:
    a = t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
    # float64 artifacts (best_model.pt) come down to the f32 parameters
    return a.astype(np.float32) if a.dtype == np.float64 else a


def load_torch_artifact(path: str, allow_full_pickle: bool = False
                        ) -> Dict[str, np.ndarray]:
    """Load a reference checkpoint into a flat {dotted_name: ndarray}.

    The three on-disk shapes the reference produces:
      * raw tensor dicts (`grud_mean_grud_para.pt`),
      * wrapper dicts (`{'rec_state_dict': ..., ...}`,
        mTAND_baseline.py:118),
      * full-module pickles (`torch.save(model)`), including pickles of
        classes that were never published, with tensor attributes kept
        outside `state_dict()` like `GRUD.x_mean`: only with
        `allow_full_pickle=True`, since unpickling them runs code named in
        the file. Without it `torch.load` reads tensors and plain
        containers alone (`weights_only=True`) and a pickled object raises
        `pickle.UnpicklingError`.
    """
    import torch

    if allow_full_pickle:
        with _stub_pickle_modules():
            obj = torch.load(path, map_location="cpu", weights_only=False)
    else:
        try:
            obj = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError as e:
            raise pickle.UnpicklingError(
                f"{path!r} is not a plain tensor dict (a full-module pickle?); "
                f"loading it runs code named in the file: pass "
                f"allow_full_pickle=True (--allow-full-pickle) for a file you "
                f"trust. torch.load said: {e}") from e

    if isinstance(obj, torch.nn.Module):
        sd = {k: _to_numpy(v) for k, v in obj.state_dict().items()}
        # plain tensor attributes the reference kept out of state_dict
        for mod_name, mod in obj.named_modules():
            prefix = mod_name + "." if mod_name else ""
            for attr, val in vars(mod).items():
                if attr.startswith("_") or not torch.is_tensor(val):
                    continue
                sd.setdefault(prefix + attr, _to_numpy(val))
        return sd
    if isinstance(obj, dict):
        flat: Dict[str, np.ndarray] = {}
        for k, v in obj.items():
            if torch.is_tensor(v):
                flat[k] = _to_numpy(v)
            elif isinstance(v, dict):  # e.g. {'rec_state_dict': {...}}
                for kk, vv in v.items():
                    if torch.is_tensor(vv):
                        flat[kk] = _to_numpy(vv)
        if flat:
            return flat
    raise ValueError(
        f"unsupported checkpoint payload {type(obj).__name__} in {path!r}")


def _lin(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """torch `nn.Linear` -> the port's `{'w': [out, in], 'b': [out]}`."""
    out = {"w": np.asarray(sd[prefix + ".weight"], np.float32)}
    if prefix + ".bias" in sd:
        out["b"] = np.asarray(sd[prefix + ".bias"], np.float32)
    return out


# -- GRU-D ------------------------------------------------------------------

GRUD_MAP = {
    "w_dg_x": "weight_dg_x", "w_dg_h": "weight_dg_h",
    "w_xz": "weight_xz", "w_hz": "weight_hz", "w_mz": "weight_mz",
    "w_xr": "weight_xr", "w_hr": "weight_hr", "w_mr": "weight_mr",
    "w_xh": "weight_xh", "w_hh": "weight_hh", "w_mh": "weight_mh",
    "w_hy": "weight_hy",
    "b_dg_x": "bias_dg_x", "b_dg_h": "bias_dg_h",
    "b_z": "bias_z", "b_r": "bias_r", "b_h": "bias_h", "b_y": "bias_y",
}


def import_grud(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Reference `models.GRUD` (code/baselines/models.py:337-440) ->
    baselines/grud.py's tree. A 1:1 rename; `x_mean` (a plain tensor
    attribute in the reference, models.py:346) is zeros when the artifact
    is a bare parameter dict without it."""
    params = {ours: np.asarray(sd[theirs], np.float32)
              for ours, theirs in GRUD_MAP.items()}
    n = params["w_xz"].shape[0]
    params["x_mean"] = np.asarray(
        sd.get("x_mean", np.zeros((n,), np.float32)), np.float32).reshape(-1)
    return params


# -- mTAND ------------------------------------------------------------------

def import_mtand(sd: Dict[str, np.ndarray],
                 n_ref: int = 128) -> Dict[str, np.ndarray]:
    """Reference `models.enc_mtan_classif` (code/baselines/mTAND/
    models.py:54-100) -> baselines/mtand.py's tree. The attention's
    `linears` ModuleList order is (query, key, out); the GRU encoder is a
    single-layer `nn.GRU`; `query_points` (the constructor's
    `torch.linspace(0, 1, n_ref)`) comes from the collected module
    attribute when present, else `np.linspace(0, 1, n_ref)` in float32."""
    params = {
        "att_q": _lin(sd, "att.linears.0"),
        "att_k": _lin(sd, "att.linears.1"),
        "att_out": _lin(sd, "att.linears.2"),
        "periodic": _lin(sd, "periodic"),
        "linear": _lin(sd, "linear"),
        "classifier": {
            "lin0": _lin(sd, "classifier.0"),
            "lin1": _lin(sd, "classifier.2"),
            "lin2": _lin(sd, "classifier.4"),
        },
        "gru": {
            "w_ih": np.asarray(sd["enc.weight_ih_l0"], np.float32),
            "w_hh": np.asarray(sd["enc.weight_hh_l0"], np.float32),
            "b_ih": np.asarray(sd["enc.bias_ih_l0"], np.float32),
            "b_hh": np.asarray(sd["enc.bias_hh_l0"], np.float32),
        },
    }
    query = next((sd[k] for k in ("query", "att.query") if k in sd), None)
    params["query_points"] = (
        np.asarray(query, np.float32).reshape(-1) if query is not None
        else np.linspace(0.0, 1.0, n_ref, dtype=np.float32))
    return params


# -- torch TransformerEncoderLayer ------------------------------------------

def import_encoder_layer(sd: Dict[str, np.ndarray],
                         prefix: str = "") -> Dict[str, object]:
    """torch `nn.TransformerEncoderLayer` state-dict slice -> one
    nn/transformer.py layer tree (in_proj/out_proj/lin1/lin2/ln1/ln2).
    `prefix` example: `'transformer_encoder.layers.0.'`."""
    g = lambda k: np.asarray(sd[prefix + k], np.float32)  # noqa: E731
    return {
        "in_proj_w": g("self_attn.in_proj_weight"),
        "in_proj_b": g("self_attn.in_proj_bias"),
        "out_proj": _lin(sd, prefix + "self_attn.out_proj"),
        "lin1": _lin(sd, prefix + "linear1"),
        "lin2": _lin(sd, prefix + "linear2"),
        "ln1": {"scale": g("norm1.weight"), "bias": g("norm1.bias")},
        "ln2": {"scale": g("norm2.weight"), "bias": g("norm2.bias")},
    }


def import_transformer_encoder(sd: Dict[str, np.ndarray],
                               prefix: str = "transformer_encoder."
                               ) -> Dict[str, object]:
    """torch `nn.TransformerEncoder` -> transformer_encoder_init's tree."""
    layers = sorted({int(k[len(prefix) + 7:].split(".")[0])
                     for k in sd if k.startswith(prefix + "layers.")})
    return {f"layer{i}": import_encoder_layer(sd, f"{prefix}layers.{i}.")
            for i in layers}


# -- Raindrop (flagship) ----------------------------------------------------

def _import_ob_propagation(sd: Dict[str, np.ndarray],
                           prefix: str) -> Dict[str, object]:
    """Reference `Observation_progation` (code/Ob_propagation.py:40-69)
    -> graph/propagate.ob_propagation_init's tree."""
    return {
        "lin_key": _lin(sd, prefix + "lin_key"),
        "lin_query": _lin(sd, prefix + "lin_query"),
        "lin_value": _lin(sd, prefix + "lin_value"),
        "lin_skip": _lin(sd, prefix + "lin_skip"),
        "weight": np.asarray(sd[prefix + "weight"], np.float32),
        "bias": np.asarray(sd[prefix + "bias"], np.float32),
        "nodewise_weights": np.asarray(
            sd[prefix + "nodewise_weights"], np.float32),
        "increase_dim": _lin(sd, prefix + "increase_dim"),
        "map_weights": np.asarray(sd[prefix + "map_weights"], np.float32),
    }


def import_raindrop(sd: Dict[str, np.ndarray],
                    static: Optional[bool] = None) -> Dict[str, object]:
    """Reference `Raindrop_v2` state dict (code/models_rd.py:208-276) ->
    models/raindrop.py's tree. The reference's dead `mlp` head
    (models_rd.py:260-264, never called in forward) is dropped; `static`
    defaults to whether the artifact carries `emb.*`."""
    params = {
        "R_u": np.asarray(sd["R_u"], np.float32),
        "encoder": _lin(sd, "encoder"),
        "ob_propagation": _import_ob_propagation(sd, "ob_propagation."),
        "ob_propagation_layer2": _import_ob_propagation(
            sd, "ob_propagation_layer2."),
        "transformer_encoder": import_transformer_encoder(sd),
        "mlp_static": {
            "lin0": _lin(sd, "mlp_static.0"),
            "lin1": _lin(sd, "mlp_static.2"),
        },
    }
    if static is None:
        static = "emb.weight" in sd
    if static:
        params["emb"] = _lin(sd, "emb")
    return params


_IMPORTERS = {
    "raindrop": import_raindrop,
    "grud": import_grud,
    "mtand": import_mtand,
    "encoder_layer": import_encoder_layer,
}


def import_params(model: str, path: str, allow_full_pickle: bool = False, **kw):
    """One-call import: load the torch artifact at `path`
    (`load_torch_artifact`) and convert it for `model` in {'raindrop',
    'grud', 'mtand', 'encoder_layer'}. Other keyword arguments reach the
    model's importer (e.g. mtand's n_ref)."""
    if model not in _IMPORTERS:
        raise ValueError(f"unknown model {model!r}; "
                         f"choose from {sorted(_IMPORTERS)}")
    sd = load_torch_artifact(path, allow_full_pickle=allow_full_pickle)
    if model == "encoder_layer":
        # best_model.pt nests its single layer under 'encoder_layer.'
        prefix = ("encoder_layer."
                  if any(k.startswith("encoder_layer.") for k in sd) else "")
        return import_encoder_layer(sd, prefix)
    return _IMPORTERS[model](sd, **kw)


def main(argv=None) -> int:
    import argparse

    from raindrop_tpu_torch.train.checkpoint import flatten_params, save_checkpoint

    ap = argparse.ArgumentParser(
        prog="python -m raindrop_tpu_torch.migrate",
        description="Import a reference torch checkpoint into a "
                    "raindrop_tpu_torch .npz checkpoint")
    ap.add_argument("--model", required=True, choices=sorted(_IMPORTERS))
    ap.add_argument("--torch", required=True, dest="torch_path",
                    help="reference .pt artifact (a state dict or a wrapper "
                         "dict; a full-module pickle with --allow-full-pickle)")
    ap.add_argument("--allow-full-pickle", action="store_true",
                    help="also load full-module pickles (torch.save(model)); "
                         "unpickling runs code named in the file: only for "
                         "files you trust")
    ap.add_argument("--mtand-n-ref", type=int, default=128,
                    help="mTAND reference-point count for bare state-dict "
                         "artifacts that do not carry the query tensor")
    ap.add_argument("--out", required=True,
                    help="output checkpoint base path (writes <out>.npz, "
                         "loadable by train/checkpoint.load_checkpoint and "
                         "serve.py --checkpoint)")
    args = ap.parse_args(argv)

    kw = ({"n_ref": args.mtand_n_ref} if args.model == "mtand" else {})
    params = import_params(args.model, args.torch_path,
                           allow_full_pickle=args.allow_full_pickle, **kw)
    out = args.out[:-4] if args.out.endswith(".npz") else args.out
    save_checkpoint(out, params,
                    meta={"source": args.torch_path, "model": args.model})
    n = sum(int(np.asarray(x).size) for _, x in flatten_params(params))
    print(f"imported {args.model}: {n} parameters -> {out}.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
