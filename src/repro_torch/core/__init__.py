"""The system's core: request states, the roofline perf model, the hardware
table and the scheduling points that the runtime and the simulator share."""
