"""Distributed runtime: fault tolerance and elasticity (the port of
``repro.runtime``; its sharding rules wait for the mesh slice)."""
