"""Decentralized-FL device side of the port: the gossip collectives on
stacked node replicas, their churn-masked plans, the DFL trainer and the
session around it."""
