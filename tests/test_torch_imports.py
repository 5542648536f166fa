"""The PyTorch port stands alone: it imports neither JAX nor ``pio_tpu``.

Every module of ``pio_tpu_torch`` is imported in a fresh interpreter with
``jax`` blocked; afterwards no ``jax*`` and no ``pio_tpu.*`` module may be
loaded. The package source and ``chip_smoke.py`` are also searched for
such imports, which catches ones hidden inside functions. Importing must not build a kernel
or need a card. The examples' counterparts on the port
(``examples/*/port/*.py``) are searched the same way.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pio_tpu_torch")

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import pio_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(
    pio_tpu_torch.__path__, "pio_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
from pio_tpu_torch import native
from pio_tpu_torch.ops.kernels import build
loaded = sorted(k for k, v in sys.modules.items() if v is not None and (
    k == "jax" or k.startswith(("jax.", "jaxlib", "pio_tpu."))
    or k == "pio_tpu"))
print(json.dumps({"modules": mods, "loaded": loaded,
                  "built": sorted(build._LIBS) + sorted(native._LIBS)}))
"""


def test_every_module_imports_without_jax_or_pio_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        | {"PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert res["built"] == []  # importing builds no kernel, no native log
    for mod in ("pio_tpu_torch.workflow.serve", "pio_tpu_torch.ops.retrieval",
                "pio_tpu_torch.ops.kernels.quantized_scan",
                "pio_tpu_torch.models.recommendation",
                "pio_tpu_torch.__main__", "pio_tpu_torch.convert",
                "pio_tpu_torch.ops.als", "pio_tpu_torch.data.eventstore",
                "pio_tpu_torch.ops.kernels.segment_flush",
                "pio_tpu_torch.ops.kernels.gather_rows",
                "pio_tpu_torch.ops.kernels.packed_matvec",
                "pio_tpu_torch.ops.kernels.flash_attention",
                "pio_tpu_torch.ops.attention", "pio_tpu_torch.ops.topk",
                "pio_tpu_torch.ops.moe",
                "pio_tpu_torch.models.sequence",
                "pio_tpu_torch.workflow.train",
                "pio_tpu_torch.parallel", "pio_tpu_torch.parallel.mesh",
                "pio_tpu_torch.parallel.distributed",
                "pio_tpu_torch.workflow.lifecycle",
                "pio_tpu_torch.workflow.spans",
                "pio_tpu_torch.workflow.step_checkpoint",
                "pio_tpu_torch.resilience.chaos",
                "pio_tpu_torch.data.columnar",
                "pio_tpu_torch.resilience.policies",
                "pio_tpu_torch.obs", "pio_tpu_torch.obs.context",
                "pio_tpu_torch.obs.recorder", "pio_tpu_torch.obs.http",
                "pio_tpu_torch.utils.tracing",
                "pio_tpu_torch.utils.httpclient",
                "pio_tpu_torch.rollout", "pio_tpu_torch.rollout.state",
                "pio_tpu_torch.rollout.split",
                "pio_tpu_torch.rollout.guards",
                "pio_tpu_torch.rollout.controller",
                "pio_tpu_torch.serving_fleet",
                "pio_tpu_torch.serving_fleet.fleet",
                "pio_tpu_torch.serving_fleet.plan",
                "pio_tpu_torch.serving_fleet.rpcwire",
                "pio_tpu_torch.serving_fleet.shard",
                "pio_tpu_torch.serving_fleet.router",
                "pio_tpu_torch.serving_fleet.reshard",
                "pio_tpu_torch.serving_fleet.tenancy",
                "pio_tpu_torch.serving_fleet.__main__",
                "pio_tpu_torch.freshness", "pio_tpu_torch.freshness.cursor",
                "pio_tpu_torch.freshness.tail",
                "pio_tpu_torch.freshness.solver",
                "pio_tpu_torch.freshness.apply",
                "pio_tpu_torch.freshness.folder",
                "pio_tpu_torch.controller.evaluation",
                "pio_tpu_torch.controller.fasteval",
                "pio_tpu_torch.e2", "pio_tpu_torch.e2.crossvalidation",
                "pio_tpu_torch.e2.metrics",
                "pio_tpu_torch.tuning", "pio_tpu_torch.tuning.metrics",
                "pio_tpu_torch.tuning.splits",
                "pio_tpu_torch.tuning.records",
                "pio_tpu_torch.tuning.sweep",
                "pio_tpu_torch.tuning.server",
                "pio_tpu_torch.workflow.evaluate",
                "pio_tpu_torch.workflow.batchpredict",
                "pio_tpu_torch.workflow.fake",
                "pio_tpu_torch.server.http",
                "pio_tpu_torch.server.eventserver",
                "pio_tpu_torch.server.stats", "pio_tpu_torch.server.plugins",
                "pio_tpu_torch.server.security",
                "pio_tpu_torch.server.webhooks",
                "pio_tpu_torch.server.webhooks.segmentio",
                "pio_tpu_torch.server.webhooks.mailchimp",
                "pio_tpu_torch.server.webhooks.example",
                "pio_tpu_torch.resilience.guard",
                "pio_tpu_torch.resilience.spill",
                "pio_tpu_torch.resilience.quota",
                "pio_tpu_torch.resilience.health",
                "pio_tpu_torch.data.backends.memory",
                "pio_tpu_torch.data.backends.localfs",
                "pio_tpu_torch.sdk", "pio_tpu_torch.tools.appops",
                "pio_tpu_torch.tools.export_import",
                "pio_tpu_torch.native", "pio_tpu_torch.native.eventlog",
                "pio_tpu_torch.data.backends.eventlog",
                "pio_tpu_torch.data.backends.wire",
                "pio_tpu_torch.data.backends.remote",
                "pio_tpu_torch.data.backends.sharded",
                "pio_tpu_torch.data.backends.replicated",
                "pio_tpu_torch.server.storageserver",
                "pio_tpu_torch.serving", "pio_tpu_torch.serving.batcher",
                "pio_tpu_torch.ops.kernels",
                "pio_tpu_torch.ops.similarity",
                "pio_tpu_torch.ops.naive_bayes",
                "pio_tpu_torch.ops.forest", "pio_tpu_torch.ops.markov",
                "pio_tpu_torch.models.filtering",
                "pio_tpu_torch.models.similarproduct",
                "pio_tpu_torch.models.ecommerce",
                "pio_tpu_torch.models.classification",
                "pio_tpu_torch.e2.vectorizer", "pio_tpu_torch.e2.engine",
                "pio_tpu_torch.ops.indicators", "pio_tpu_torch.ops.simrank",
                "pio_tpu_torch.models.stock",
                "pio_tpu_torch.models.regression",
                "pio_tpu_torch.models.friendrecommendation",
                "pio_tpu_torch.models.twotower",
                "pio_tpu_torch.controller.external"):
        assert mod in res["modules"]


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    # the card's smoke run and the trainers' timer stand alone too
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "port_train_ab.py")
    # and so does the user code written for the port
    examples = os.path.join(REPO, "examples")
    for name in sorted(os.listdir(examples)):
        port_dir = os.path.join(examples, name, "port")
        if os.path.isdir(port_dir):
            for f in sorted(os.listdir(port_dir)):
                if f.endswith(".py"):
                    yield os.path.join(port_dir, f)


_FORBIDDEN = re.compile(
    r"^\s*(?:from\s+(?:jax|jaxlib|pio_tpu)(?:\.|\s)"
    r"|import\s+(?:jax|jaxlib|pio_tpu)\b(?!_torch))", re.M)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_source_has_no_jax_or_pio_tpu_import(path):
    with open(path) as f:
        src = f.read()
    assert not _FORBIDDEN.findall(src)
    # nor a module path handed to importlib as a string
    assert not re.findall(r"""["'](?:jax|pio_tpu)[.:"']""", src)
