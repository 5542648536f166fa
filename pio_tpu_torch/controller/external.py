"""External (any-language) engine bridge — the cross-language binding story.

Counterpart of ``pio_tpu.controller.external``, the same bridge and wire
protocol: the engine process touches no tensor, so nothing here runs on a
device.

The reference ships a Java controller API (core/src/main/java/.../
controller/java/*, e.g. LJavaAlgorithm) so engines can be written outside
Scala. A Python framework's equivalent isn't a JVM shim but a PROCESS
protocol: the engine is any executable speaking line-delimited JSON-RPC on
stdio, and this module bridges it into the DASE pipeline. Train spawns the
engine process, streams it the training events, and stores the opaque JSON
model it returns in the regular model store; deploy re-spawns it, loads the
model once, and proxies queries (a lock serializes the pipe — the child is
free to be internally parallel).

Wire protocol (one JSON object per line on stdin/stdout; stderr is logged):

  -> {"id": 1, "method": "describe", "params": {}}
  <- {"id": 1, "result": {"name": "...", "protocol": 1}}
  -> {"id": 2, "method": "train",
      "params": {"events": [<event wire dicts>], "config": {...}}}
  <- {"id": 2, "result": {"model": <any json>}}
  -> {"id": 3, "method": "load_model", "params": {"model": ..., "config": ...}}
  <- {"id": 3, "result": {}}
  -> {"id": 4, "method": "predict", "params": {"query": {...}}}
  <- {"id": 4, "result": {"prediction": {...}}}
  -> {"id": 5, "method": "predict_batch", "params": {"queries": [...]}}
  <- {"id": 5, "result": {"predictions": [...]}}      (optional method)

Errors: {"id": N, "error": {"message": "..."}}. An engine that doesn't
implement predict_batch returns an error for it and the bridge falls back
to per-query predicts. `examples/external-engine/` holds a stdlib-only
reference implementation of the engine side.
"""

from __future__ import annotations

import json
import logging
import queue
import subprocess
import threading
from dataclasses import dataclass, field
from typing import Any, Sequence

from pio_tpu_torch.controller.base import (
    DataSource,
    FirstServing,
    IdentityPreparator,
    LAlgorithm,
    Params,
)
from pio_tpu_torch.controller.engine import Engine, EngineFactory

log = logging.getLogger("pio_tpu_torch.external")


class ExternalEngineError(RuntimeError):
    pass


class ExternalProcess:
    """One engine child process; request/response over stdio lines."""

    def __init__(self, command: Sequence[str], cwd: str | None = None,
                 timeout: float = 600.0):
        if not command:
            raise ExternalEngineError("external engine command is empty")
        self.command = list(command)
        self.timeout = timeout
        self.dead = False          # set when the bridge kills/abandons it
        self._lock = threading.Lock()
        self._next_id = 0
        try:
            self._proc = subprocess.Popen(
                self.command, cwd=cwd,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, bufsize=1,
            )
        except OSError as e:
            raise ExternalEngineError(
                f"cannot spawn external engine {self.command}: {e}"
            ) from e
        # drain stderr on a thread so the child can't block on a full pipe;
        # read stdout on a thread too, so call() can enforce its timeout
        # (a blocking readline could never be interrupted)
        self._out_q: queue.Queue[str] = queue.Queue()
        self._stdout_thread = threading.Thread(
            target=self._read_stdout, daemon=True
        )
        self._stdout_thread.start()
        self._stderr_thread = threading.Thread(
            target=self._drain_stderr, daemon=True
        )
        self._stderr_thread.start()

    def _read_stdout(self):
        try:
            for line in self._proc.stdout:
                self._out_q.put(line)
        except ValueError:
            pass  # pipe closed
        self._out_q.put("")  # EOF sentinel

    def _drain_stderr(self):
        try:
            for line in self._proc.stderr:
                log.info("[external %s] %s", self.command[0], line.rstrip())
        except ValueError:
            pass  # pipe closed

    def call(self, method: str, params: dict | None = None,
             timeout: float | None = None) -> Any:
        """timeout: None = the process default; <= 0 = wait indefinitely
        (training runs are legitimately long)."""
        timeout = self.timeout if timeout is None else timeout
        with self._lock:
            if self.dead or (
                self._proc.poll() is not None and self._out_q.empty()
            ):
                raise ExternalEngineError(
                    f"external engine {self.command} exited with "
                    f"rc={self._proc.poll()}"
                )
            self._next_id += 1
            req_id = self._next_id
            msg = json.dumps(
                {"id": req_id, "method": method, "params": params or {}}
            )
            try:
                self._proc.stdin.write(msg + "\n")
                self._proc.stdin.flush()
            except (BrokenPipeError, OSError) as e:
                self.dead = True
                raise ExternalEngineError(
                    f"external engine {self.command} pipe broke during "
                    f"{method}: {e}"
                ) from e
            try:
                line = self._out_q.get() if timeout <= 0 \
                    else self._out_q.get(timeout=timeout)
            except queue.Empty:
                # a hung engine would wedge the pipe; SIGKILL may not be
                # reaped by the time the caller retries, so mark dead
                # explicitly rather than trusting poll()
                self.dead = True
                self._proc.kill()
                raise ExternalEngineError(
                    f"external engine {self.command} did not answer "
                    f"{method} within {timeout}s; killed"
                ) from None
        if not line:
            raise ExternalEngineError(
                f"external engine {self.command} closed stdout during "
                f"{method} (rc={self._proc.poll()})"
            )
        try:
            resp = json.loads(line)
        except json.JSONDecodeError as e:
            raise ExternalEngineError(
                f"external engine sent invalid JSON for {method}: "
                f"{line[:200]!r}"
            ) from e
        if resp.get("id") != req_id:
            raise ExternalEngineError(
                f"external engine answered id {resp.get('id')} to request "
                f"{req_id} ({method}); the protocol is strictly serial"
            )
        if "error" in resp:
            raise ExternalEngineError(
                f"{method}: {resp['error'].get('message', resp['error'])}"
            )
        return resp.get("result")

    def close(self):
        proc = self._proc
        if proc.poll() is None:
            try:
                proc.stdin.close()
            except OSError:
                pass
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()


# ---------------------------------------------------------------------------
# DASE wrappers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExternalDataSourceParams(Params):
    app_name: str = ""
    event_names: tuple = ()


class ExternalDataSource(DataSource):
    """Reads the app's events and hands them to the external engine as wire
    dicts (the Event Server's JSON shape, so any language's existing client
    model applies)."""

    params_class = ExternalDataSourceParams

    def __init__(self, params: ExternalDataSourceParams):
        self.params = params

    def read_training(self, ctx) -> list[dict]:
        events = ctx.event_store.find(
            app_name=self.params.app_name,
            event_names=list(self.params.event_names) or None,
        )
        return [e.to_api_dict() for e in events]


@dataclass(frozen=True)
class ExternalAlgorithmParams(Params):
    command: tuple = ()        # argv of the engine executable
    config: dict = field(default_factory=dict)  # passed through verbatim
    workdir: str = ""          # cwd for the child ("" = inherit)
    timeout: float = 600.0     # per-RPC limit for serving/describe calls
    train_timeout: float = 0.0  # train limit; <= 0 = unbounded (trains
                                # are legitimately long; 0 matches the
                                # reference's unbounded train)

    # the engine loader absolutizes these against the engine directory
    path_fields = ("workdir",)


class ExternalAlgorithm(LAlgorithm):
    """Bridges train/predict to the engine process. The stored model is the
    opaque JSON the engine returned from `train` plus enough to respawn it
    at deploy."""

    params_class = ExternalAlgorithmParams

    def __init__(self, params: ExternalAlgorithmParams):
        self.params = params
        self._proc: ExternalProcess | None = None
        self._loaded_key: int | None = None
        self._proc_lock = threading.Lock()
        self._batch_unsupported = False

    def _spawn(self) -> ExternalProcess:
        # the CLI absolutizes a relative workdir against the engine dir at
        # load time (__main__._absolutize_param_paths); one still relative here
        # (programmatic construction) resolves against the process cwd
        return ExternalProcess(
            self.params.command, cwd=self.params.workdir or None,
            timeout=self.params.timeout,
        )

    def train(self, ctx, events: list[dict]) -> dict:
        proc = self._spawn()
        try:
            info = proc.call("describe") or {}
            model = proc.call("train", {
                "events": events, "config": dict(self.params.config),
            }, timeout=self.params.train_timeout)
            if not isinstance(model, dict) or "model" not in model:
                raise ExternalEngineError(
                    "train must return {\"model\": <json>}"
                )
            return {
                "engine": info.get("name", self.params.command[0]),
                "model": model["model"],
            }
        finally:
            proc.close()

    def _serving_proc(self, model: dict) -> ExternalProcess:
        """Keep one child alive across predicts; (re)load on model change
        (reload hot-swap) or child death."""
        with self._proc_lock:
            key = id(model)
            if self._proc is not None and (
                self._loaded_key != key
                or self._proc.dead
                or self._proc._proc.poll() is not None
            ):
                self._proc.close()
                self._proc = None
            if self._proc is None:
                self._proc = self._spawn()
                self._proc.call("load_model", {
                    "model": model["model"],
                    "config": dict(self.params.config),
                })
                self._loaded_key = key
            return self._proc

    def predict(self, model: dict, query: dict) -> Any:
        proc = self._serving_proc(model)
        out = proc.call("predict", {"query": query})
        if not isinstance(out, dict) or "prediction" not in out:
            raise ExternalEngineError(
                "predict must return {\"prediction\": <json>}; got "
                f"{str(out)[:200]!r}"
            )
        return out["prediction"]

    _UNSUPPORTED_MARKERS = ("unknown method", "not implemented",
                            "unsupported", "no such method")

    def batch_predict(self, model: dict, queries) -> list:
        proc = self._serving_proc(model)
        if not self._batch_unsupported:
            try:
                out = proc.call(
                    "predict_batch", {"queries": list(queries)}
                ) or {}
                preds = out.get("predictions")
                if isinstance(preds, list) and len(preds) == len(queries):
                    return preds
                raise ExternalEngineError(
                    "predict_batch must return {\"predictions\": [...]} "
                    "matching the query count"
                )
            except ExternalEngineError as e:
                msg = str(e).lower()
                if any(m in msg for m in self._UNSUPPORTED_MARKERS):
                    # optional method: remember the refusal so the hot
                    # path doesn't pay a probe round-trip per batch
                    self._batch_unsupported = True
                    log.warning(
                        "external engine has no predict_batch (%s); "
                        "falling back to per-query predicts", e,
                    )
                else:
                    # a real failure (timeout, crash, protocol bug) must
                    # surface, not silently disable batching forever
                    raise
        return [self.predict(model, q) for q in queries]

    def close(self):
        """Stop the serving child (hooked by QueryServer.close())."""
        with self._proc_lock:
            if self._proc is not None:
                self._proc.close()
                self._proc = None
                self._loaded_key = None


class ExternalEngine(EngineFactory):
    """engine.json shape:

        {"engineFactory": "pio_tpu_torch.controller.external.ExternalEngine",
         "datasource": {"params": {"app_name": "X"}},
         "algorithms": [{"name": "external",
                         "params": {"command": ["python3", "my_engine.py"],
                                    "config": {...}}}]}
    """

    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            ExternalDataSource,
            IdentityPreparator,
            {"external": ExternalAlgorithm},
            FirstServing,
        )
