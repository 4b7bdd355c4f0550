"""The DFL chain: node workflow, heap simulator, attacks, scenarios."""
