"""Event/engine server plugin interface.

Reference: data/.../api/EventServerPlugin.scala + core
workflow/EngineServerPlugin.scala:21-39, loaded via ServiceLoader. Here
plugins register explicitly (or via entry-point style module paths in
config); two kinds on each server:

 * input/output *blockers* — may raise to reject a request;
 * input/output *sniffers* — observe asynchronously, cannot block.
"""

from __future__ import annotations

from typing import Any, Callable


class PluginRejection(Exception):
    """Raised by a blocker plugin to reject a request (HTTP 403)."""


class EventServerPlugin:
    INPUT_BLOCKER = "inputblocker"
    INPUT_SNIFFER = "inputsniffer"

    plugin_name = "plugin"
    plugin_type = INPUT_SNIFFER

    def process(self, event_dict: dict, context: dict) -> None:
        """Blockers raise PluginRejection to reject; sniffers observe."""


class EngineServerPlugin:
    OUTPUT_BLOCKER = "outputblocker"
    OUTPUT_SNIFFER = "outputsniffer"

    plugin_name = "plugin"
    plugin_type = OUTPUT_SNIFFER

    def process(self, query: dict, prediction: dict, context: dict) -> dict:
        """Output blockers may transform/replace the prediction; sniffers
        observe. Return the (possibly modified) prediction."""
        return prediction

    def handle_rest(self, path: str, params: dict) -> Any:
        """Reference EngineServerPlugin.handleREST — /plugins/* endpoint."""
        return {"plugin": self.plugin_name}


class PluginContext:
    """Holds registered plugins for one server instance
    (reference EventServerPluginContext / EngineServerPluginContext.scala:49-76)."""

    def __init__(self, plugins: list | None = None):
        self.plugins = list(plugins or [])

    def _of(self, plugin_type: str) -> list:
        return [p for p in self.plugins if p.plugin_type == plugin_type]

    @property
    def input_blockers(self):
        return self._of(EventServerPlugin.INPUT_BLOCKER)

    @property
    def input_sniffers(self):
        return self._of(EventServerPlugin.INPUT_SNIFFER)

    @property
    def output_blockers(self):
        return self._of(EngineServerPlugin.OUTPUT_BLOCKER)

    @property
    def output_sniffers(self):
        return self._of(EngineServerPlugin.OUTPUT_SNIFFER)

    def get(self, name: str):
        for p in self.plugins:
            if p.plugin_name == name:
                return p
        return None
