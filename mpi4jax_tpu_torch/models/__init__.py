"""Models built on the port: the shallow-water solver and the long-context attention demo."""
