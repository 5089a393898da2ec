"""Orchestrator plugins (reference: plugins/ — cilium-cni and the
cilium-docker libnetwork remote driver)."""
