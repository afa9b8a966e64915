"""Plain references the cells are judged against (torch and numpy only)."""
