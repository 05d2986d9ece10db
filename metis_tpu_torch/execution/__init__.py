"""Plan artifact and single-device training step of the port."""
