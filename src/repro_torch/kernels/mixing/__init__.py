"""FedAvg mix kernel: Hopper kernel wrapper, plain version and dispatch."""
