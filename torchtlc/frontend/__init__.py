"""Toolbox model resolution (MC.cfg, MC.tla, .launch) for the port."""
