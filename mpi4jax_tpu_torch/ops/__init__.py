"""Communication ops: sendrecv, gather, alltoall, tokens."""
