"""Process entry points (reference cmd/: kube-scheduler, …)."""
