"""Configurations of the port: the paper's own workload (``pir_ct``)."""
