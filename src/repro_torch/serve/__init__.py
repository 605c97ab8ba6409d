"""The port's serving engines (dense and paged) and the page allocator."""
