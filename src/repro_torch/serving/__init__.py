"""The online serving front end."""
