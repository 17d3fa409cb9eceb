"""Host-side serving parts: the page allocator and prefix trie of the
paged KV cache (``pages``) and the fabric's decode-backend face over the
port's ``DecodeServer`` (``backend``)."""
