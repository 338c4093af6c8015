"""Runtime services of the port: the TCP enhancement server."""
