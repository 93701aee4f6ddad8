"""Audio front end of the port: the log-mel chain."""
