"""Shared pieces of the port's template tests: an example engine directory
copied with its engine.json naming the port's factory, the train verb in
process or as a subprocess from another working directory, the trained
instance served over HTTP (what ``deploy`` serves), and ``batchpredict``
of a query file."""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")


def sqlite_env(path) -> dict:
    return {"PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_SQL_PATH": str(path),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL"}


def copy_example(example: str, dest, factory: str, **algo_params) -> dict:
    """examples/<example> copied to ``dest`` (data files included), its
    engine.json's engineFactory set to ``factory`` and the first
    algorithm's params updated with ``algo_params``; -> the variant."""
    shutil.copytree(os.path.join(EXAMPLES, example), dest)
    path = os.path.join(dest, "engine.json")
    with open(path) as f:
        variant = json.load(f)
    variant["engineFactory"] = factory
    variant["algorithms"][0]["params"].update(algo_params)
    with open(path, "w") as f:
        json.dump(variant, f)
    return variant


def train_in_process(engine_dir, storage, monkeypatch, cwd, *extra) -> int:
    """``python -m pio_tpu_torch train --engine-dir D --device cpu`` in this
    process, from ``cwd``, on ``storage``."""
    from pio_tpu_torch.__main__ import main

    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    monkeypatch.chdir(cwd)
    return main(["train", "--engine-dir", str(engine_dir), "--device",
                 "cpu", *extra])


def train_subprocess(engine_dir, env: dict, cwd, timeout: float = 240):
    """The train verb as its own process, started in ``cwd``."""
    return subprocess.run(
        [sys.executable, "-m", "pio_tpu_torch", "train", "--engine-dir",
         str(engine_dir), "--device", "cpu"],
        cwd=str(cwd), capture_output=True, text=True, timeout=timeout,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        | env | {"PYTHONPATH": REPO})


def batchpredict(engine_dir, storage, monkeypatch, queries, tmp) -> list:
    """``python -m pio_tpu_torch batchpredict --device cpu`` of
    ``queries`` in this process; -> the predictions, in query order."""
    from pio_tpu_torch.__main__ import main

    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    inp, out = os.path.join(tmp, "q.jsonl"), os.path.join(tmp, "p.jsonl")
    with open(inp, "w") as f:
        f.writelines(json.dumps(q) + "\n" for q in queries)
    assert main(["batchpredict", "--engine-dir", str(engine_dir),
                 "--device", "cpu", "--input", inp, "--output", out,
                 "--batch-size", "3"]) == 0
    with open(out) as f:
        lines = [json.loads(line) for line in f]
    assert [x["query"] for x in lines] == queries
    return [x["prediction"] for x in lines]


def post(port: int, body, path: str = "/queries.json"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


@contextlib.contextmanager
def deployed(engine_dir, storage, engine_id: str):
    """The engine directory's latest COMPLETED instance served over HTTP
    on the CPU; yields (port, query server)."""
    from pio_tpu_torch.__main__ import _engine_from_variant, _load_variant
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.serve import ServingConfig, create_query_server

    engine, ep = _engine_from_variant(_load_variant(str(engine_dir)),
                                      str(engine_dir))
    http, qs = create_query_server(
        engine, ep, storage,
        ServingConfig(ip="127.0.0.1", port=0, engine_id=engine_id),
        ctx=create_workflow_context(storage, device="cpu"))
    http.start()
    try:
        yield http.port, qs
    finally:
        http.stop()
        qs.close()


def served_as_in_process(port: int, qs, queries) -> list:
    """Each query over HTTP, its body held to the serving composition's
    answer in process (every algorithm's predict through the serving);
    -> the bodies."""
    bodies = []
    for q in queries:
        status, body = post(port, q)
        assert status == 200, body
        want = qs.serving.serve(q, [a.predict(m, q) for a, m in
                                    zip(qs.algorithms, qs.models)])
        assert body == json.loads(json.dumps(want)), (q, body, want)
        bodies.append(body)
    return bodies
