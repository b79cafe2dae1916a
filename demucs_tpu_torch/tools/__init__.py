"""Command-line tools of the port: the trainer (`train_cli`)."""
