"""The PyTorch port imports no JAX: every module of ``deepmerge_tpu_torch``,
the serving driver and the CLI included, loads in a fresh interpreter with
``jax`` absent from ``sys.modules``."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import deepmerge_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    deepmerge_tpu_torch.__path__, "deepmerge_tpu_torch.")]
for name in names:
    importlib.import_module(name)
jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print(json.dumps({"modules": names, "jax": jax_mods}))
"""


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
                 "deepmerge_tpu_torch.__main__"):
        assert name in seen["modules"]
    assert len(seen["modules"]) >= 20
    assert seen["jax"] == [], f"the port pulled in {seen['jax']}"
