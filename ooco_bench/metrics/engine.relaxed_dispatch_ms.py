"""Mean host wall of a relaxed-pool engine dispatch, as
``engine.strict_dispatch_ms`` for the strict pool."""


def read(record):
    return record["dispatch_ms"]["relaxed"]
