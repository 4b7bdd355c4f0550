"""Core DFL math: topologies, Eq. 2/3 FedAvg, reputation, wire compression."""
