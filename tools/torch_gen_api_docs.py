#!/usr/bin/env python3
"""Generate docs/API_torch.md, the API reference of the PyTorch/CUDA
port (``pailliercryptolib_python_tpu_torch``).

Counterpart of ``tools/gen_api_docs.py``, which documents the JAX
package: it introspects the port's public surface and writes one
markdown file from the live docstrings and signatures.  Imports
``torch`` and the port only, never ``jax``, and opens no device.
Regenerate after API changes:

    python tools/torch_gen_api_docs.py            # writes docs/API_torch.md
    python tools/torch_gen_api_docs.py --out PATH
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PKG = "pailliercryptolib_python_tpu_torch"
# (module, [public names]; None = the module's own public functions)
SURFACE = [
    (PKG, [
        "PaillierKeypair", "PaillierPublicKey", "PaillierPrivateKey",
        "PaillierEncryptedNumber", "BNUtils", "from_jax_state",
    ]),
    (f"{PKG}.device", ["get_device", "set_device"]),
    (f"{PKG}.fixedpoint", [
        "FixedPointNumber", "FixedPointEndec", "encode_vector",
        "decode_vector", "decode_limbs_vector",
    ]),
    (f"{PKG}.bindings.containers", [
        "ipclKeypair", "ipclPublicKey", "ipclPrivateKey", "ipclPlainText",
        "ipclCipherText", "BigNumber",
    ]),
    (f"{PKG}.utils.context", ["context", "hybridControl", "hybridMode"]),
    (f"{PKG}.utils.config", ["Config", "get_config", "set_config"]),
    (f"{PKG}.models.paillier", [
        "generate_key_ints", "generate_prime", "PublicContext",
        "PrivateContext",
    ]),
    (f"{PKG}.parallel.mesh", [
        "make_mesh", "batch_bounds", "shard_batch", "replicate",
    ]),
    (f"{PKG}.parallel.collective", [
        "sharded_he_sum", "sharded_elementwise", "federated_aggregate",
        "count_collectives",
    ]),
    (f"{PKG}.parallel.sharded_ops", ["sharded_decrypt", "sharded_mul_pt"]),
    (f"{PKG}.parallel.distributed", None),
    (f"{PKG}.parallel.entry", ["entry", "dryrun_multichip"]),
]
DUNDERS = ("__add__", "__sub__", "__mul__", "__truediv__", "__matmul__",
           "__getitem__")


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    return inspect.getdoc(obj) or "*(no docstring)*"


def _first(obj) -> str:
    return (_doc(obj).splitlines() or [""])[0]


def _emit(out: list, name: str, obj) -> None:
    if not inspect.isclass(obj):
        out += [f"### `def {name}{_sig(obj)}`\n", _doc(obj) + "\n"]
        return
    out += [f"### `class {name}`\n", _doc(obj) + "\n"]
    for mname, m in inspect.getmembers(obj):
        if mname.startswith("_") and mname not in DUNDERS:
            continue
        static = inspect.getattr_static(obj, mname)
        if isinstance(static, property):
            out.append(f"- **`{mname}`** (property) — {_first(m)}")
        elif inspect.isfunction(m) or inspect.ismethod(m) or isinstance(
                static, (staticmethod, classmethod)):
            out.append(f"- **`{mname}{_sig(m)}`** — {_first(m)}")
    if hasattr(obj, "__members__"):                 # an enum
        out.append("- members: " + ", ".join(f"`{n}`"
                                             for n in obj.__members__))
    out.append("")


def render() -> str:
    """The whole reference as markdown."""
    version = importlib.import_module(PKG).__version__
    out = [
        f"# API reference — {PKG} {version}",
        "",
        "The PyTorch/CUDA port of `pailliercryptolib_python_tpu` (whose "
        "reference is `docs/API.md`). Generated by "
        "`tools/torch_gen_api_docs.py` from live docstrings. Do not edit "
        "by hand.",
        "",
        "The `ipcl_python_torch` package is an import alias: `from "
        "ipcl_python_torch import PaillierKeypair` resolves to the same "
        "objects documented here, with the port's `__version__` "
        f"(\"{version}\").",
        "",
    ]
    for modname, names in SURFACE:
        mod = importlib.import_module(modname)
        out += [f"\n## module `{modname}`\n",
                (inspect.getdoc(mod) or "").split("\n\n")[0] + "\n"]
        if names is None:
            names = [n for n, o in inspect.getmembers(mod, inspect.isfunction)
                     if not n.startswith("_") and o.__module__ == modname]
        for name in names:
            _emit(out, name, getattr(mod, name))
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "docs",
                                                  "API_torch.md"))
    args = ap.parse_args(argv)
    text = render()
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out} ({len(text.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
