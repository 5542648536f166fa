"""Serving fleet: of the reference's package the port has
``resolve_fleet_model`` alone (``serving_fleet/fleet.py``), the persisted
factor model the fold-in worker solves against. The router, the shard
servers, the plan and the wire come with the fleet slice.
"""
