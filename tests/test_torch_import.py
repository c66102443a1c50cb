"""The PyTorch port stands alone: every module of ``deepmerge_tpu_torch``,
the serving and training drivers and the CLI included, loads in a fresh
interpreter with neither ``jax`` nor any module of the JAX package
(``deepmerge_tpu``) in ``sys.modules``; and no source of the port, nor
``chip_smoke.py``, imports either, not even inside a function."""

import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "deepmerge_tpu")

_PROBE = """
import importlib, json, pkgutil, sys
import deepmerge_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    deepmerge_tpu_torch.__path__, "deepmerge_tpu_torch.")]
for name in names:
    importlib.import_module(name)
def loaded(root):
    return sorted(m for m in sys.modules
                  if m == root or m.startswith(root + "."))
print(json.dumps({"modules": names, "jax": loaded("jax"),
                  "reference": loaded("deepmerge_tpu")}))
"""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("deepmerge_tpu_torch.infer.extract",
                 "deepmerge_tpu_torch.infer.driver",
                 "deepmerge_tpu_torch.train.driver",
                 "deepmerge_tpu_torch.ops.kernels.fused_attention",
                 "deepmerge_tpu_torch.config",
                 "deepmerge_tpu_torch.geodata.ingest",
                 "deepmerge_tpu_torch.native.unionfind",
                 "deepmerge_tpu_torch.utils.parity",
                 "deepmerge_tpu_torch.__main__"):
        assert name in seen["modules"]
    assert len(seen["modules"]) >= 35
    assert seen["jax"] == [], f"the port pulled in {seen['jax']}"
    assert seen["reference"] == [], \
        f"the port pulled in the JAX package: {seen['reference']}"


def test_no_source_imports_the_jax_package():
    """Every ``import`` and ``from ... import`` of the port's sources and of
    ``chip_smoke.py``, at any depth of the syntax tree."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "deepmerge_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 36
    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                      for n in names if _forbidden(n)]
    assert found == []
