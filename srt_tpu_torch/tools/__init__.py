"""The port's user-facing tools: ``render_demo`` (the one-command visual
check) and ``interactive_session`` (``RenderSession``'s frame rates)."""
