"""Communication ops: sendrecv, gather, tokens."""
