"""Host linear-system backends of the SQP solver (the "qdldl" oracle)."""
