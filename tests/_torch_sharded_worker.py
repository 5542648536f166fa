"""One rank of the port's sharded ALS, run as a process by
tests/test_torch_als_sharded.py:

    python tests/_torch_sharded_worker.py CASES_DIR OUT.npz

with the PIO_TPU_* variables of its rank set. It joins the group through
``create_workflow_context`` on the CPU, trains every case of
``CASES_DIR/cases.json`` (arrays in ``cases.npz``) with
``als_train_sharded`` in each of the case's accumulation modes, trains
the template cases through ``ALSAlgorithm.train`` on the
two-rank context (``als_train`` there raises, so only the sharded branch
can answer), and writes every factor matrix to ``OUT.npz``."""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import json
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from pio_tpu_torch.data.bimap import EntityIdIndex
from pio_tpu_torch.data.eventstore import Interactions
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.models import recommendation as rec
from pio_tpu_torch.ops import als
from pio_tpu_torch.parallel import distributed
from pio_tpu_torch.workflow.context import create_workflow_context

MEMORY = {"PIO_STORAGE_SOURCES_M_TYPE": "memory",
          "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
          "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
          "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M"}


def _refuse(*args, **kwargs):
    raise AssertionError("the template trained on one device")


def main(cases_dir: str, out: str) -> int:
    ctx = create_workflow_context(Storage(env=MEMORY), device="cpu")
    mesh = ctx.mesh
    cases = json.loads((Path(cases_dir) / "cases.json").read_text())
    arrays = np.load(Path(cases_dir) / "cases.npz")
    got = {"rank": np.asarray(mesh.rank), "size": np.asarray(mesh.size),
           "backend": np.asarray(distributed.backend())}
    for case in cases:
        name = case["name"]
        coo = [arrays[f"{name}/{k}"] for k in ("u", "i", "v")]
        shape = (case["n_users"], case["n_items"])
        init = None
        if case["init"]:
            init = als.ALSModel(*(torch.from_numpy(
                arrays[f"{name}/{k}"]) for k in ("users0", "items0")))
        params = als.ALSParams(**case["params"])
        for accum in case["accums"]:
            m = als.als_train_sharded(*coo, *shape,
                                      replace(params, **accum["params"]),
                                      mesh, init=init)
            got[f"{name}/{accum['name']}/users"] = m.user_factors.numpy()
            got[f"{name}/{accum['name']}/items"] = m.item_factors.numpy()
        if case.get("template"):
            algo = rec.ALSAlgorithm(
                rec.ALSAlgorithmParams(**case["template"]))
            data = Interactions(
                *coo, EntityIdIndex(f"u{n}" for n in range(shape[0])),
                EntityIdIndex(f"i{n}" for n in range(shape[1])))
            rec.als.als_train = rec.als.als_train_validated = _refuse
            model = algo.train(ctx, data)
            got[f"{name}/template/users"] = model.factors.user_factors.numpy()
            got[f"{name}/template/items"] = model.factors.item_factors.numpy()
    distributed.barrier("worker-done")
    np.savez(out, **got)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
