"""Share of the online requests due in the window that met both SLOs at the
client (``clientstats.slo_attainment``), in percent."""


def read(record):
    return 100.0 * record["client"]["slo_attainment"]
