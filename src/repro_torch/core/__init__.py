"""Federated-learning core of the port: host control, cohort megastep
and the event-driven simulation."""
