"""Decentralized-FL device side of the port: the gossip collectives on
stacked node replicas and their churn-masked plans."""
