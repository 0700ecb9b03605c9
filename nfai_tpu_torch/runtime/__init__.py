"""Runtime: the inference engine and chat session, the paged KV pool and
the continuous-batching scheduler."""
