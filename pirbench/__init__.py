"""The port's benchmark: private certificate lookups at CT-log scale."""
