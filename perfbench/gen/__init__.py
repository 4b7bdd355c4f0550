"""Input generators: what a cell's runs are fed, drawn from ``--seed``."""
