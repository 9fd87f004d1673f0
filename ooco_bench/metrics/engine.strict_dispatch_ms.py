"""Mean host wall of a strict-pool engine dispatch (decode step, horizon,
mixed step, mixed horizon or whole-prompt prefill), from its call to its
return after the token sync, over the window outside the profiled slice."""


def read(record):
    return record["dispatch_ms"]["strict"]
