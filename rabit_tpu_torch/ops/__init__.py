"""Row passes of a boosting round and their reference histograms."""
