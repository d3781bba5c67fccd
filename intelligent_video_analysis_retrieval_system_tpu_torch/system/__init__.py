"""The embedder, the health monitor and the user-facing facade."""
