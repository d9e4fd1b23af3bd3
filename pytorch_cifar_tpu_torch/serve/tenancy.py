"""Multi-tenant zoo serving: so far only the routing miss.

The port's counterpart of ``pytorch_cifar_tpu/serve/tenancy.py`` holds
just :class:`UnknownModel` for now: the frontend, the edge and the router
catch it (a well-formed request naming a model nobody serves is a 404).
The zoo server itself (``ModelZooServer``, ``TenantSpec``) is not ported
yet.
"""

from __future__ import annotations


class UnknownModel(LookupError):
    """A request named a model this server does not host — the HTTP
    frontend maps this to 404 (the request was well-formed; the tenant
    is absent). Deliberately NOT a ValueError: the frontend's 400
    mapping must never swallow it."""
