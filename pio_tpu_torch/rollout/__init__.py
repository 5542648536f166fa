"""Guarded model rollout: of the reference's package the port has the
durable rollout records alone (``rollout/state.py``, a verbatim copy),
which the fold-in worker consults to solve against the instance that
serving auto-loads. The canary controller, its guards and the traffic
split come with the serving slice that ports rollout arms.
"""
