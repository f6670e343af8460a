"""GC slot compaction (a victim's live slot metadata to its destinations)."""
