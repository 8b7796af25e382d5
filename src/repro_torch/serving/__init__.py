"""Serving layer of the port: engines, paged cache, scheduler, server."""
